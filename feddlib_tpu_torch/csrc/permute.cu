// Permutation gather y[i] = idx[i] >= 0 ? x[idx[i]] : 0 (f32).
//
// Replaces the TPU kernel feddlib_tpu/la/permute.py:206 _permute_pallas
// (kernel body _make_kernel).  That kernel needed a window plan (8 or 16
// column windows of 128 lanes per output chunk, int16 lane indices, a 0/1
// mask and a scatter tail for spilled outputs) because a TPU gathers only
// inside a 128-lane register.  A Hopper thread can load any address, so the
// plan is just the flat int32 index vector.
//
// Bound on the H100: bytes, 4 * n_in + 8 * n_out (x read once, 4 B of index
// read and 4 B of y written per output, no arithmetic) at 3.35 TB/s: 0.00295
// ms at the P2 elasticity split gathers (823,875 values), under 1 us at the
// padded solves' ghost fetches (266,240 and 208,896 values).  Those two lie
// below the fixed cost of a launch (an empty one-block kernel takes 0.00184
// ms back to back on the H100, launch_floor_ms of chip_smoke.py).  At the
// split gathers the plan's scatter holds the rest: their gather
// instructions touch 6 to 7 times the 32-byte sectors of x, and the same
// kernel on an identity plan of that size takes half the time.
//
// Design.  One output a thread made each thread wait for its index and then
// for one dependent 4 B gather, and took ceil(n/256) blocks: 3.05 waves at
// the split gathers, the last one 5 % full.  Now each warp takes a tile of
// 32 * kPer consecutive outputs and each lane kPer of them, 32 apart, so the
// index loads, the gathers and the stores of one instruction are 32
// consecutive outputs and coalesce as one output a thread did (four
// consecutive outputs a thread in 16-byte loads spread one gather
// instruction over 128 outputs and was slower than one a thread), and a
// lane's gathers are issued before any is used.  The grid is at most one
// wave (as many CTAs as the card holds at once); beyond that, a grid-stride
// loop loads the next tile's indices while the current gathers are in
// flight.  The ragged end is a bounds check per output, so any alignment
// takes the same kernel.  kPer = 2 measured faster than 1, 4 and 8.
//
// What the layout alone could not move is the fixed cost of a launch, about
// 1 us of the 3 us at the ghost fetches.  So the kernel is launched with
// programmatic stream serialization (programmatic dependent launch): its
// CTAs start while the kernel ahead of it drains, prefetch their plan's
// lines to L2 (the L2 is the point of coherence, so a plan the kernel ahead
// writes is still read right), and wait at griddepcontrol.wait for that
// kernel's results before the first load of x or idx and the first store of
// y.  An L2 evict-last hint on the index loads moved nothing and is not
// used.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;           // outputs a lane
constexpr int kTile = 32 * kPer;  // outputs a warp

// the tile's indices of this lane; -1 past the end
__device__ __forceinline__ void load_tile(const int* __restrict__ idx,
                                          long long base, long long n_out,
                                          int (&j)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + 32 * k;
    j[k] = i < n_out ? __ldg(idx + i) : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
    permute_gather_kernel(const float* __restrict__ x,
                          const int* __restrict__ idx, float* __restrict__ y,
                          long long n_out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_tiles = (n_out + kTile - 1) / kTile;
  if (w < n_tiles) {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (w * kTile + 32 * k + lane < n_out)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            idx + w * kTile + 32 * k + lane));
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  int j[kPer];
  if (w < n_tiles) load_tile(idx, w * kTile + lane, n_out, j);
  while (w < n_tiles) {
    const long long next = w + warps;
    int jn[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) jn[k] = -1;
    if (next < n_tiles) load_tile(idx, next * kTile + lane, n_out, jn);
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      v[k] = j[k] >= 0 ? __ldg(x + j[k]) : 0.0f;
    const long long base = w * kTile + lane;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (base + 32 * k < n_out) y[base + 32 * k] = v[k];
#pragma unroll
    for (int k = 0; k < kPer; ++k) j[k] = jn[k];
    w = next;
  }
}

}  // namespace

// Launches one kernel for every n_out >= 0 (n_out = 0 writes nothing).
extern "C" int fedd_permute_gather_f32(const float* x, const int* idx,
                                       float* y, long long n_out,
                                       cudaStream_t stream) {
  if (n_out < 0) return (int)cudaErrorInvalidValue;
  // as many CTAs as the card holds at once, and no more than the tiles
  static int per_sm = 0;
  if (per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, permute_gather_kernel, kThreads, 0) != cudaSuccess ||
       per_sm < 1))
    per_sm = 1;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles_per_block = kThreads / 32;
  long long blocks =
      ((n_out + kTile - 1) / kTile + tiles_per_block - 1) / tiles_per_block;
  const long long wave = (long long)(sms > 0 ? sms : 1) * per_sm;
  if (blocks > wave) blocks = wave;  // grid-stride beyond one wave
  if (blocks < 1) blocks = 1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, permute_gather_kernel, x, idx, y, n_out);
  return (int)cudaGetLastError();
}
