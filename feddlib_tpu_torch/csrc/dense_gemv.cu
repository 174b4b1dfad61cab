// Batched dense-block GEMV y[p, r] = sum_w blocks[p, r, w] * xs[p, w].
//
// Replaces two TPU kernels of feddlib_tpu/la/pallas_kernels.py:
//   - dense_block_mv_pallas (f32 blocks, f32 x): fedd_dense_gemv_f32;
//   - dense_block_mv_lowp_pallas (bf16 blocks, x rounded to bf16 first,
//     products widened to f32, f32 accumulation): fedd_dense_gemv_bf16.
// The TPU kernels ran one cluster block per grid step through the MXU.  Here
// the contraction is a GEMV, one multiply-add per matrix element, so it has
// no use for tensor cores: it runs on the CUDA cores in true f32.
//
// Bound on the H100: bytes.  The [P, R, W] block stream is read exactly once
// per apply (4 or 2 B per element, 2 flops each); xs and y are small.  At the
// padded-cluster solve's shapes the f32 stream is about a gigabyte, far above
// the 50 MB L2, so the kernel is a device-memory stream.
//
// f32 design (W % 4 == 0, 16-byte aligned blocks and xs): a bulk-copy ring
// over a resident grid.  One tile of 64 rows a CTA left a tail wave (3.15
// waves at [128, 1624, 3256]) and tail tiles, stalled every CTA on staging
// x before its first load, and drained its loads at every row.  Now the
// grid has as many CTAs as the card holds at once (two an SM), each owning
// an equal contiguous range of the flattened P*R rows.  A CTA's rows are one
// contiguous byte range: one producer thread copies it into a ring of
// shared-memory stages (whole rows of one cluster, about 32 KB a stage,
// three stages) with 1D TMA bulk copies (cp.async.bulk, completion on an
// mbarrier, L2 evict-first: the store is read once), keeping the ring full
// with no registers spent on the copy; x[p] comes the same way into one of
// two buffers whenever the range enters a new cluster, and the first copies
// go out before any x is needed.  Eight consumer warps take the rows in
// turn, each as float4 against x[p] in shared memory, reduce with shuffles
// and write y once a row, then release the stage.  Any other W or alignment,
// or a row too long for two stages, takes the general kernel (one CTA of 8
// warps per 64-row tile, x staged in shared memory, 16-byte loads where the
// alignment allows).
// bf16 design (W % 8 == 0, aligned store): a row one warp walked alone kept
// only one or two 16-byte loads per lane in flight behind the previous row's
// shuffles, and 64-row tiles left a tail tile at R = 136.  Now the grid has
// no more CTAs than the card holds at once, each owning whole slabs of rows
// of one cluster; each warp is software-pipelined, loading its next step of
// up to 4 rows (or 8 pieces a lane of one long row) while it multiplies the
// current one, and x[p] sits in shared memory as bf16 (x is rounded to bf16
// first anyway), so a lane's 8 x values are one conflict-free 16-byte load
// and widening to f32 is a shift.  Any other W or alignment takes the
// general kernel (lanes over elements).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void dense_gemv_f32_kernel(const float* __restrict__ blocks,
                                      const float* __restrict__ xs,
                                      float* __restrict__ y, int P, int R,
                                      int W, int tiles, bool vec) {
  extern __shared__ float4 smem4[];
  float* xsh = reinterpret_cast<float*>(smem4);
  const int p = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const float* xp = xs + (size_t)p * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) xsh[i] = xp[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = tile * kRowsPerBlock + warp * kRowsPerWarp + k;
    if (r >= R) break;
    const float* row = blocks + ((size_t)p * R + r) * W;
    float acc = 0.0f;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int W4 = W >> 2;
      for (int i = lane; i < W4; i += 32) {
        const float4 a = __ldg(row4 + i);
        const float4 b = smem4[i];
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    } else {
      for (int i = lane; i < W; i += 32) acc = fmaf(__ldg(row + i), xsh[i], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) y[(size_t)p * R + r] = acc;
  }
}

// B4, the general case (any W, any alignment): lanes over the elements of
// a row, one row after another per warp, x in shared memory as f32.
__global__ void dense_gemv_bf16_any_kernel(
    const __nv_bfloat16* __restrict__ blocks, const float* __restrict__ xs,
    float* __restrict__ y, int R, int W, int tiles) {
  extern __shared__ float4 smem4[];
  float* xsh = reinterpret_cast<float*>(smem4);
  const int p = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const float* xp = xs + (size_t)p * W;
  // x is rounded to the store type first (round to nearest even), as the
  // TPU kernel's xs.astype(blocks.dtype); bf16 x bf16 is exact in f32
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    xsh[i] = __bfloat162float(__float2bfloat16(xp[i]));
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = tile * kRowsPerBlock + warp * kRowsPerWarp + k;
    if (r >= R) break;
    const __nv_bfloat16* row = blocks + ((size_t)p * R + r) * W;
    float acc = 0.0f;
    for (int i = lane; i < W; i += 32)
      acc = fmaf(__bfloat162float(row[i]), xsh[i], acc);
    acc = warp_sum(acc);
    if (lane == 0) y[(size_t)p * R + r] = acc;
  }
}

// Eight bf16 products of two 16-byte pieces added to acc in f32; a bf16 is
// the upper half of an f32, so widening is a shift or a mask.
__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b, float acc) {
  const unsigned hi = 0xffff0000u;
  acc = fmaf(__uint_as_float(a.x << 16), __uint_as_float(b.x << 16), acc);
  acc = fmaf(__uint_as_float(a.x & hi), __uint_as_float(b.x & hi), acc);
  acc = fmaf(__uint_as_float(a.y << 16), __uint_as_float(b.y << 16), acc);
  acc = fmaf(__uint_as_float(a.y & hi), __uint_as_float(b.y & hi), acc);
  acc = fmaf(__uint_as_float(a.z << 16), __uint_as_float(b.z << 16), acc);
  acc = fmaf(__uint_as_float(a.z & hi), __uint_as_float(b.z & hi), acc);
  acc = fmaf(__uint_as_float(a.w << 16), __uint_as_float(b.w << 16), acc);
  acc = fmaf(__uint_as_float(a.w & hi), __uint_as_float(b.w & hi), acc);
  return acc;
}

template <int G, int TR>
__device__ __forceinline__ void load_rows(uint4 (&u)[G][TR],
                                          const uint4* __restrict__ bp,
                                          int r0, int r_hi, int base,
                                          int W8) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int i = base + 32 * j;
      u[g][j] = (r0 + g < r_hi && i < W8)
                    ? __ldg(bp + (size_t)(r0 + g) * W8 + i)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
}

// B4, W % 8 == 0 and a 16-byte aligned store: a row is W/8 whole 16-byte
// pieces.  A CTA owns rows [r_lo, r_hi) of cluster p and stages x[p] in
// shared memory as bf16, so a lane reads the 8 x values of its piece with
// one conflict-free 16-byte load.  Each warp owns a contiguous run of those
// rows and walks it in steps of G rows by 32 * TR pieces (G * TR <= 4, or
// one row of TR <= 8 pieces a lane): it loads the next step into a second
// set of registers before it multiplies the current one, so every warp
// keeps a step in flight from the first load (issued before x is staged)
// to the last.  A row ends with a shuffle reduction and one store.
template <int TR>
__global__ void __launch_bounds__(kWarps * 32)
dense_gemv_bf16_vec_kernel(const uint4* __restrict__ blocks,
                           const float* __restrict__ xs,
                           float* __restrict__ y, int R, int W,
                           int rows_per_cta, int slabs) {
  constexpr int G = TR >= 4 ? 1 : 4 / TR;
  extern __shared__ uint4 xh4[];
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(xh4);
  const int p = blockIdx.x / slabs;
  const int r_lo = (blockIdx.x % slabs) * rows_per_cta;
  const int r_hi = min(R, r_lo + rows_per_cta);
  const int W8 = W >> 3;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_warp = (r_hi - r_lo + kWarps - 1) / kWarps;
  int r0 = r_lo + warp * per_warp;   // the step: rows r0 .. r0 + G - 1,
  int pb = 0;                        // pieces pb + lane + 32 * j
  const int w_hi = min(r_hi, r0 + per_warp);
  const uint4* bp = blocks + (size_t)p * R * W8;
  float* yp = y + (size_t)p * R;
  uint4 cur[G][TR], nxt[G][TR];
  load_rows<G, TR>(cur, bp, r0, w_hi, pb + lane, W8);
  const float* xp = xs + (size_t)p * W;
  // round to nearest even, as the TPU kernel's xs.astype(blocks.dtype)
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    xh[i] = __float2bfloat16(xp[i]);
  __syncthreads();
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  while (r0 < w_hi) {   // the same trips for every lane of the warp
    int r1 = r0, pb1 = pb + 32 * TR;
    if (pb1 >= W8) {
      pb1 = 0;
      r1 += G;
    }
    load_rows<G, TR>(nxt, bp, r1, w_hi, pb1 + lane, W8);
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int i = pb + lane + 32 * j;
      if (i < W8) {
        const uint4 xv = xh4[i];
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g] = dot_bf16x8(cur[g][j], xv, acc[g]);
      }
    }
    if (pb1 == 0) {   // the G rows are complete
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (lane == 0 && r0 + g < w_hi) yp[r0 + g] = acc[g];
        acc[g] = 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < TR; ++j) cur[g][j] = nxt[g][j];
    r0 = r1;
    pb = pb1;
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int TR>
int launch_bf16_vec(const __nv_bfloat16* blocks, const float* xs, float* y,
                    int P, int R, int W, cudaStream_t stream) {
  const auto kernel = dense_gemv_bf16_vec_kernel<TR>;
  const size_t smem = ((size_t)W * 2 + 15) / 16 * 16;
  int e = set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  // as many CTAs as are resident on the card, and no more than one per
  // cluster unless there are fewer clusters than that: no tail tiles
  static size_t cached_smem = (size_t)-1;
  static int per_sm = 1;
  if (cached_smem != smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kWarps * 32, smem) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    cached_smem = smem;
  }
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long target = (long long)(sms > 0 ? sms : 1) * per_sm;
  long long slabs = target / P;
  if (slabs > (R + kWarps - 1) / kWarps) slabs = (R + kWarps - 1) / kWarps;
  if (slabs < 1) slabs = 1;
  const int rows_per_cta = (int)((R + slabs - 1) / slabs);
  slabs = (R + rows_per_cta - 1) / rows_per_cta;
  const long long grid = (long long)P * slabs;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kWarps * 32, smem, stream>>>(
      reinterpret_cast<const uint4*>(blocks), xs, y, R, W, rows_per_cta,
      (int)slabs);
  return (int)cudaGetLastError();
}

int launch_bf16(const __nv_bfloat16* blocks, const float* xs, float* y,
                int P, int R, int W, cudaStream_t stream) {
  if (P <= 0 || R <= 0) return (int)cudaGetLastError();
  if (W % 8 == 0 && W > 0 &&
      reinterpret_cast<uintptr_t>(blocks) % 16 == 0) {
    const int trips = (W / 8 + 31) / 32;
    switch (trips < 8 ? trips : 8) {
      case 1: return launch_bf16_vec<1>(blocks, xs, y, P, R, W, stream);
      case 2: return launch_bf16_vec<2>(blocks, xs, y, P, R, W, stream);
      case 3: return launch_bf16_vec<3>(blocks, xs, y, P, R, W, stream);
      case 4: return launch_bf16_vec<4>(blocks, xs, y, P, R, W, stream);
      case 5: return launch_bf16_vec<5>(blocks, xs, y, P, R, W, stream);
      case 6: return launch_bf16_vec<6>(blocks, xs, y, P, R, W, stream);
      case 7: return launch_bf16_vec<7>(blocks, xs, y, P, R, W, stream);
      default: return launch_bf16_vec<8>(blocks, xs, y, P, R, W, stream);
    }
  }
  const size_t smem = ((size_t)W * sizeof(float) + 15) / 16 * 16;
  int e = set_smem((const void*)dense_gemv_bf16_any_kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long grid = (long long)P * tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dense_gemv_bf16_any_kernel<<<(unsigned)grid, kWarps * 32, smem, stream>>>(
      blocks, xs, y, R, W, tiles);
  return (int)cudaGetLastError();
}

// -- B3: the bulk-copy ring -------------------------------------------------

constexpr int kRingConsumers = 8;                    // consumer warps
constexpr int kRingThreads = (kRingConsumers + 1) * 32;
constexpr int kRingMaxStages = 8;
constexpr int kRingHeader = 256;                     // mbarriers, 128-aligned
constexpr size_t kRingStageTarget = 32 * 1024;
// two CTAs an SM (each with 1 KB reserved) in the 228 KB of shared memory
constexpr size_t kRingSmemMax = 116224;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, 16-byte aligned at both ends) from global
// to shared memory; the copy completes `bytes` of the barrier's expected
// transactions, which this thread announces first.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Rows of the next stage: at most rps, and never past the end of the
// cluster or of the CTA's range, so a stage has one x[p].
__device__ __forceinline__ int stage_rows(long long r, long long hi, int R,
                                          int rps) {
  const long long end = min(hi, (r / R + 1) * R);
  return (int)min((long long)rps, end - r);
}

__global__ void __launch_bounds__(kRingThreads, 2)
dense_gemv_f32_ring_kernel(const float* __restrict__ blocks,
                           const float* __restrict__ xs,
                           float* __restrict__ y, int R, int W,
                           long long n_rows, long long rows_per_cta, int rps,
                           int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRingMaxStages;
  uint64_t* xfull = empty + kRingMaxStages;
  uint64_t* xempty = xfull + 2;
  float* xbuf = reinterpret_cast<float*>(smem + kRingHeader);   // [2][W]
  float* ring = xbuf + 2 * (size_t)W;                            // [S][rps*W]
  const size_t stage_floats = (size_t)rps * W;
  const long long lo = (long long)blockIdx.x * rows_per_cta;
  const long long hi = min(n_rows, lo + rows_per_cta);
  if (lo >= hi) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kRingConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(xfull + b, 1);
      mbar_init(xempty + b, kRingConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kRingConsumers) {   // the producer
    if (lane != 0) return;
    long long p_cur = -1;
    int k = -1;                   // clusters entered so far, minus one
    int u = 0;                    // stages copied so far
    for (long long r = lo; r < hi; ++u) {
      const long long p = r / R;
      if (p != p_cur) {           // x[p] into buffer k & 1
        p_cur = p;
        ++k;
        if (k >= 2) mbar_wait(xempty + (k & 1), ((k >> 1) - 1) & 1);
        bulk_load(xbuf + (k & 1) * (size_t)W, xs + p * W, (uint32_t)W * 4,
                  xfull + (k & 1));
      }
      const int n = stage_rows(r, hi, R, rps);
      const int s = u % stages;
      if (u >= stages) mbar_wait(empty + s, ((u / stages) - 1) & 1);
      bulk_load(ring + s * stage_floats, blocks + r * W,
                (uint32_t)n * W * 4, full + s);
      r += n;
    }
    return;
  }

  // consumers: row q of the range (q = r - lo) belongs to warp q % 8; every
  // warp waits on every stage and releases it, in order
  const int W4 = W >> 2;
  long long p_cur = -1;
  int k = -1;
  const float4* x4 = nullptr;
  int u = 0;
  for (long long r = lo; r < hi; ++u) {
    const long long p = r / R;
    if (p != p_cur) {
      if (k >= 0) {               // done with the last cluster's x
        __syncwarp();
        if (lane == 0) mbar_arrive(xempty + (k & 1));
      }
      p_cur = p;
      ++k;
      mbar_wait(xfull + (k & 1), (k >> 1) & 1);
      x4 = reinterpret_cast<const float4*>(xbuf + (k & 1) * (size_t)W);
    }
    const int n = stage_rows(r, hi, R, rps);
    const int s = u % stages;
    mbar_wait(full + s, (u / stages) & 1);
    const float4* st =
        reinterpret_cast<const float4*>(ring + s * stage_floats);
    const int q0 = (int)((r - lo) % kRingConsumers);
    for (int j = (warp - q0 + kRingConsumers) % kRingConsumers; j < n;
         j += kRingConsumers) {
      const float4* row = st + (size_t)j * W4;
      float acc0 = 0.0f, acc1 = 0.0f;
      int i = lane;
      for (; i + 32 < W4; i += 64) {
        const float4 a = row[i], b = x4[i];
        const float4 c = row[i + 32], e = x4[i + 32];
        acc0 = fmaf(a.x, b.x, acc0);
        acc1 = fmaf(c.x, e.x, acc1);
        acc0 = fmaf(a.y, b.y, acc0);
        acc1 = fmaf(c.y, e.y, acc1);
        acc0 = fmaf(a.z, b.z, acc0);
        acc1 = fmaf(c.z, e.z, acc1);
        acc0 = fmaf(a.w, b.w, acc0);
        acc1 = fmaf(c.w, e.w, acc1);
      }
      if (i < W4) {
        const float4 a = row[i], b = x4[i];
        acc0 = fmaf(a.x, b.x, acc0);
        acc0 = fmaf(a.y, b.y, acc0);
        acc0 = fmaf(a.z, b.z, acc0);
        acc0 = fmaf(a.w, b.w, acc0);
      }
      const float acc = warp_sum(acc0 + acc1);
      if (lane == 0) y[r + j] = acc;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    r += n;
  }
}

// The ring's shape for rows of W floats: rows per stage and stages, or
// false when two stages of one row and the two x buffers do not fit.
bool ring_shape(int R, int W, int* rps, int* stages, size_t* smem) {
  const size_t row = (size_t)W * 4;
  size_t n = kRingStageTarget / row;
  if (n < 1) n = 1;
  if (n > (size_t)R) n = R;
  const size_t fixed = kRingHeader + 2 * row;
  if (fixed + 2 * n * row > kRingSmemMax) return false;
  size_t s = (kRingSmemMax - fixed) / (n * row);
  if (s > kRingMaxStages) s = kRingMaxStages;
  *rps = (int)n;
  *stages = (int)s;
  *smem = fixed + s * n * row;
  return true;
}

int launch_f32_ring(const float* blocks, const float* xs, float* y, int P,
                    int R, int W, int rps, int stages, size_t smem,
                    cudaStream_t stream) {
  const auto kernel = dense_gemv_f32_ring_kernel;
  int e = set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  static size_t cached_smem = (size_t)-1;
  static int per_sm = 1;
  if (cached_smem != smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kRingThreads, smem) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    cached_smem = smem;
  }
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long n_rows = (long long)P * R;
  long long grid = (long long)(sms > 0 ? sms : 1) * per_sm;
  if (grid > n_rows) grid = n_rows;
  const long long rows_per_cta = (n_rows + grid - 1) / grid;
  grid = (n_rows + rows_per_cta - 1) / rows_per_cta;
  kernel<<<(unsigned)grid, kRingThreads, smem, stream>>>(
      blocks, xs, y, R, W, n_rows, rows_per_cta, rps, stages);
  return (int)cudaGetLastError();
}

int launch_f32(const float* blocks, const float* xs, float* y, int P, int R,
               int W, cudaStream_t stream) {
  if (P <= 0 || R <= 0) return (int)cudaGetLastError();
  const bool vec = (W % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(blocks) % 16 == 0);
  int rps = 0, stages = 0;
  size_t ring_smem = 0;
  if (vec && W > 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
      ring_shape(R, W, &rps, &stages, &ring_smem))
    return launch_f32_ring(blocks, xs, y, P, R, W, rps, stages, ring_smem,
                           stream);
  const size_t smem = ((size_t)W * sizeof(float) + 15) / 16 * 16;
  int e = set_smem((const void*)dense_gemv_f32_kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long grid = (long long)P * tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dense_gemv_f32_kernel<<<(unsigned)grid, kWarps * 32, smem, stream>>>(
      blocks, xs, y, P, R, W, tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fedd_dense_gemv_f32(const float* blocks, const float* xs,
                                   float* y, int P, int R, int W,
                                   cudaStream_t stream) {
  return launch_f32(blocks, xs, y, P, R, W, stream);
}

extern "C" int fedd_dense_gemv_bf16(const __nv_bfloat16* blocks,
                                    const float* xs, float* y, int P, int R,
                                    int W, cudaStream_t stream) {
  return launch_bf16(blocks, xs, y, P, R, W, stream);
}
