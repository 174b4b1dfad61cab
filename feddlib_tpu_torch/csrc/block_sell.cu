// Block-SELL SpMV, f32, over d x d node blocks on planar vectors:
//   y[ci, r] = sum_s sum_cj vals[c, ci*d + cj, s] * x[cj, col(r, s)].
//
// Replaces the TPU kernel feddlib_tpu/la/sell.py:_block_sell_mv_pallas
// (kernel body _make_block_kernel).  It reads the layout the JAX package
// builds, unchanged:
//   vals [nchunks, d*d, 8, 128] f32 (one [8, 128] plane per block entry),
//   pidx [nchunks, 8, 128] int16 = k*128 + lane, on the NODE pattern,
//   bids [nchunks, K] int32 (the 128-node windows of x a chunk touches),
//   x    [d, nx2*128] f32 planar (component cj at offset cj*nx2*128),
//   y    [d, nchunks*8*128/E] f32 planar.
// Node row r owns the E consecutive slots r*E .. r*E+E-1 of the chunk-local
// [8, 128] plane (chunk c = r / (8*128/E)), exactly as in the scalar kernel
// (sell.cu).  Slot s reads node column bids[c, pidx >> 7] * 128 + (pidx & 127).
// Padding slots hold value 0 and pidx 0, and a padded chunk's bids are 0, so
// they read node 0: in range and multiplied by 0.  The COO spill and the cut
// to the first nn nodes stay outside the kernel (torch), as they are plain
// XLA in JAX.
//
// The TPU kernel made K masked lane-gather passes per component, summed lanes
// to rows with a 0/1 matmul at Precision.HIGHEST, looped over 64 chunks per
// grid step and gave way to XLA above 2048 chunks (a scalar-memory limit).
// None of that carries over: a thread loads any address, rows are summed in
// true f32 on the CUDA cores (no tensor cores, no TF32), and the grid covers
// any chunk count.
//
// Bound on the H100: bytes.  Per slot d*d*4 B of values and 2 B of index
// stream in once for 2*d*d operations; x is read through L2.  Design:
// T = min(E, 32) neighbouring threads share one node row, so a warp reads 32
// consecutive slots (64 B of indices, then 128 B coalesced from each of the
// d*d value planes).  A thread resolves its slot's column once, loads the d
// values x[cj, col], keeps d partial sums, and the T threads combine them
// with warp shuffles; one lane writes y[ci, r].  d = 2 and 3 are unrolled
// (D template); any other d runs the same kernel with a loop over ci that
// re-reads the (cached) index per output component.
#include <cuda_runtime.h>

namespace {

constexpr int kChunkSlots = 8 * 128;

template <int T>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, T);
  return v;
}

// D > 0: d == D, unrolled.  D == 0: runtime d.
template <int T, int D>
__global__ void block_sell_spmv_f32_kernel(
    const float* __restrict__ vals, const short* __restrict__ pidx,
    const int* __restrict__ bids, const float* __restrict__ x,
    float* __restrict__ y, long long n_rows, int rpc, int K, int E, int d_rt,
    long long x_stride) {
  const int d = D > 0 ? D : d_rt;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of loop trips (the bound is
  // rounded up to whole warps), so the shuffles always see a full warp
  const long long bound = (n_rows * T + 31) / 32 * 32;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < bound; g += stride) {
    const long long r = g / T;
    const int t = (int)(g % T);
    const bool live = r < n_rows;
    const long long c = live ? r / rpc : 0;
    const int in_chunk = live ? (int)(r - c * rpc) * E : 0;
    const int* win = bids + c * K;
    const short* prow = pidx + c * kChunkSlots + in_chunk;
    const float* vrow = vals + c * (long long)(d * d) * kChunkSlots + in_chunk;
    if constexpr (D > 0) {
      float acc[D];
#pragma unroll
      for (int ci = 0; ci < D; ++ci) acc[ci] = 0.0f;
      if (live) {
        for (int s = t; s < E; s += T) {
          const int p = (int)__ldg(prow + s);
          const long long col = (long long)__ldg(win + (p >> 7)) * 128 + (p & 127);
          float xv[D];
#pragma unroll
          for (int cj = 0; cj < D; ++cj) xv[cj] = __ldg(x + cj * x_stride + col);
#pragma unroll
          for (int ci = 0; ci < D; ++ci)
#pragma unroll
            for (int cj = 0; cj < D; ++cj)
              acc[ci] = fmaf(__ldg(vrow + (ci * D + cj) * kChunkSlots + s),
                             xv[cj], acc[ci]);
        }
      }
#pragma unroll
      for (int ci = 0; ci < D; ++ci) {
        const float sum = group_sum<T>(acc[ci]);
        if (t == 0 && live) y[ci * n_rows + r] = sum;
      }
    } else {
      for (int ci = 0; ci < d; ++ci) {
        float acc = 0.0f;
        if (live) {
          for (int s = t; s < E; s += T) {
            const int p = (int)__ldg(prow + s);
            const long long col =
                (long long)__ldg(win + (p >> 7)) * 128 + (p & 127);
            for (int cj = 0; cj < d; ++cj)
              acc = fmaf(__ldg(vrow + (long long)(ci * d + cj) * kChunkSlots + s),
                         __ldg(x + cj * x_stride + col), acc);
          }
        }
        const float sum = group_sum<T>(acc);
        if (t == 0 && live) y[ci * n_rows + r] = sum;
      }
    }
  }
}

template <int T, int D>
void launch(const float* vals, const short* pidx, const int* bids,
            const float* x, float* y, long long n_rows, int rpc, int K, int E,
            int d, long long x_stride, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n_rows * T + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  block_sell_spmv_f32_kernel<T, D><<<(unsigned)blocks, threads, 0, stream>>>(
      vals, pidx, bids, x, y, n_rows, rpc, K, E, d, x_stride);
}

template <int T>
void launch_d(const float* vals, const short* pidx, const int* bids,
              const float* x, float* y, long long n_rows, int rpc, int K,
              int E, int d, long long x_stride, cudaStream_t stream) {
  switch (d) {
    case 2: launch<T, 2>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, x_stride, stream); break;
    case 3: launch<T, 3>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, x_stride, stream); break;
    default: launch<T, 0>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, x_stride, stream); break;
  }
}

}  // namespace

// y must hold d * nchunks * 8 * 128 / E values; E is a power of two <= 128;
// x holds d planes of nx2 * 128 values.
extern "C" int fedd_block_sell_spmv_f32(const float* vals, const short* pidx,
                                        const int* bids, const float* x,
                                        float* y, long long nchunks, int K,
                                        int E, int d, int nx2,
                                        cudaStream_t stream) {
  if (E < 1 || E > 128 || (E & (E - 1)) != 0 || d < 1 || nx2 < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const int rpc = 8 * (128 / E);
  const long long n_rows = nchunks * rpc;
  const long long xs = (long long)nx2 * 128;
  if (n_rows > 0) {
    switch (E < 32 ? E : 32) {
      case 1: launch_d<1>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, xs, stream); break;
      case 2: launch_d<2>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, xs, stream); break;
      case 4: launch_d<4>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, xs, stream); break;
      case 8: launch_d<8>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, xs, stream); break;
      case 16: launch_d<16>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, xs, stream); break;
      default: launch_d<32>(vals, pidx, bids, x, y, n_rows, rpc, K, E, d, xs, stream); break;
    }
  }
  return (int)cudaGetLastError();
}
