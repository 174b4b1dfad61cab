// Windowed sliced-ELL SpMV, f32: y[r] = sum_s vals[r, s] * x[col(r, s)].
//
// Replaces the TPU kernel feddlib_tpu/la/sell.py:_sell_mv_pallas (kernel
// body _make_kernel).  It reads the same layout the JAX package builds:
//   vals [nchunks, 8, 128] f32, pidx [nchunks, 8, 128] int16 = k*128 + lane,
//   bids [nchunks, K] int32 (the 128-column windows of x a chunk touches),
// with row r of the matrix owning the E consecutive slots r*E .. r*E+E-1
// (chunk c = r / (8*128/E); the slot of sublane/lane of the TPU layout
// flattens to exactly this).  Slot s reads column
//   bids[c, pidx >> 7] * 128 + (pidx & 127).
// Padding slots hold value 0 and point at a real column, so every read is in
// range.  The COO spill of rows with more than K windows stays outside the
// kernel (torch index_add_), as it is plain XLA in JAX.
//
// The TPU kernel selected window rows with a K-pass loop and summed lanes to
// rows with a 0/1 matmul at Precision.HIGHEST; here each row is summed
// directly in true f32 on the CUDA cores (no tensor cores, no TF32).
//
// Bound on the H100: bytes.  Per slot 4 B of value and 2 B of index stream
// in once; x is read through L2.  Design: T = min(E, 32) neighbouring
// threads share one row, so a warp reads 32 consecutive slots (coalesced
// 128 B of values and 64 B of indices), each thread strides over E/T slots,
// and the T partial sums are combined with warp shuffles.
#include <cuda_runtime.h>

namespace {

template <int T>
__global__ void sell_spmv_f32_kernel(const float* __restrict__ vals,
                                     const short* __restrict__ pidx,
                                     const int* __restrict__ bids,
                                     const float* __restrict__ x,
                                     float* __restrict__ y,
                                     long long n_rows, int rpc, int K, int E) {
  const long long n_threads = n_rows * T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of loop trips (n_threads is
  // rounded up to whole warps by the loop bound below), so the shuffles
  // always see a full warp
  const long long bound = (n_threads + 31) / 32 * 32;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < bound; g += stride) {
    const long long r = g / T;
    const int t = (int)(g % T);
    float acc = 0.0f;
    if (r < n_rows) {
      const long long c = r / rpc;
      const int* win = bids + c * K;
      const long long base = r * E;
      for (int s = t; s < E; s += T) {
        const int p = (int)__ldg(pidx + base + s);
        const int col = __ldg(win + (p >> 7)) * 128 + (p & 127);
        acc = fmaf(__ldg(vals + base + s), __ldg(x + col), acc);
      }
    }
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off, T);
    if (t == 0 && r < n_rows) y[r] = acc;
  }
}

template <int T>
void launch(const float* vals, const short* pidx, const int* bids,
            const float* x, float* y, long long n_rows, int rpc, int K,
            int E, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n_rows * T + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  sell_spmv_f32_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      vals, pidx, bids, x, y, n_rows, rpc, K, E);
}

}  // namespace

// y must hold nchunks * 8 * 128 / E values; E is a power of two <= 128.
extern "C" int fedd_sell_spmv_f32(const float* vals, const short* pidx,
                                  const int* bids, const float* x, float* y,
                                  long long nchunks, int K, int E,
                                  cudaStream_t stream) {
  if (E < 1 || E > 128 || (E & (E - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int rpc = 8 * (128 / E);
  const long long n_rows = nchunks * rpc;
  if (n_rows > 0) {
    switch (E < 32 ? E : 32) {
      case 1: launch<1>(vals, pidx, bids, x, y, n_rows, rpc, K, E, stream); break;
      case 2: launch<2>(vals, pidx, bids, x, y, n_rows, rpc, K, E, stream); break;
      case 4: launch<4>(vals, pidx, bids, x, y, n_rows, rpc, K, E, stream); break;
      case 8: launch<8>(vals, pidx, bids, x, y, n_rows, rpc, K, E, stream); break;
      case 16: launch<16>(vals, pidx, bids, x, y, n_rows, rpc, K, E, stream); break;
      default: launch<32>(vals, pidx, bids, x, y, n_rows, rpc, K, E, stream); break;
    }
  }
  return (int)cudaGetLastError();
}
