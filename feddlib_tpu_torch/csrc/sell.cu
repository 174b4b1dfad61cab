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
// in once; x (about a megabyte at the solver's shapes) is gathered through
// L1/L2.  The cost to beat is latency: each slot's x address depends on its
// index, which depends on the chunk's window list.  Design:
//   - one CTA of 256 threads owns one chunk (8 x 128 = 1,024 slots, the
//     TPU's own tile) at a time; thread t takes the 4 consecutive slots
//     4t .. 4t+3: one 16-byte load of values and one 8-byte load of four
//     int16 indices, coalesced across the warp;
//   - E is a template parameter, so the row of a slot is a shift: E/4
//     threads share a row and combine their sums in log2(E/4) shuffle steps
//     (E = 1, 2: a thread covers 4/E whole rows and stores them as a vector);
//   - the chunk's window ids (K <= 256: pidx holds k < 256) sit in shared
//     memory, so the chain per slot is index -> shared window id -> x;
//   - persistent CTAs (as many as are resident on the card) walk the chunks
//     with a stride of the grid, and each loads the next chunk's values,
//     indices and window ids into registers before it computes the current
//     one, so a chunk's stream is in flight while the previous chunk's x
//     gathers and shuffles run.
// Pointers that are not 16/8-byte aligned take scalar loads (same kernel).
// Staging the chunk's K windows of x in shared memory with cp.async instead
// (the TPU kernel's windows-in-VMEM structure) measured 1.6-2.1x slower on
// the H100: it copies whole windows to save scattered reads that L1 serves.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // one chunk of 1,024 slots, 4 per thread
constexpr int kChunk = 1024;
constexpr int kMaxWin = 256;    // pidx = k*128 + lane in int16, so k < 256

__device__ __forceinline__ void load_slots(const float* __restrict__ vals,
                                           const short* __restrict__ pidx,
                                           long long s0, bool vec, float4& v,
                                           uint2& p) {
  if (vec) {
    v = __ldg(reinterpret_cast<const float4*>(vals + s0));
    p = __ldg(reinterpret_cast<const uint2*>(pidx + s0));
  } else {
    v = make_float4(__ldg(vals + s0), __ldg(vals + s0 + 1),
                    __ldg(vals + s0 + 2), __ldg(vals + s0 + 3));
    p.x = (unsigned short)__ldg(pidx + s0) |
          ((unsigned)(unsigned short)__ldg(pidx + s0 + 1) << 16);
    p.y = (unsigned short)__ldg(pidx + s0 + 2) |
          ((unsigned)(unsigned short)__ldg(pidx + s0 + 3) << 16);
  }
}

// Sums thread t's four products (slots 4t .. 4t+3 of chunk c) into rows and
// writes them.  Every thread of the CTA calls it (the shuffles need whole
// warps).
template <int E>
__device__ __forceinline__ void emit(float4 v, float x0, float x1, float x2,
                                     float x3, float* __restrict__ y,
                                     long long c, int t) {
  if constexpr (E == 1) {
    reinterpret_cast<float4*>(y + c * kChunk)[t] =
        make_float4(v.x * x0, v.y * x1, v.z * x2, v.w * x3);
  } else if constexpr (E == 2) {
    reinterpret_cast<float2*>(y + c * (kChunk / 2))[t] =
        make_float2(fmaf(v.y, x1, v.x * x0), fmaf(v.w, x3, v.z * x2));
  } else {
    constexpr int T = E / 4;   // threads per row
    float acc = fmaf(v.w, x3, fmaf(v.z, x2, fmaf(v.y, x1, v.x * x0)));
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if ((t & (T - 1)) == 0) y[c * (kChunk / E) + t / T] = acc;
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads)
sell_spmv_f32_kernel(const float* __restrict__ vals,
                     const short* __restrict__ pidx,
                     const int* __restrict__ bids,
                     const float* __restrict__ x, float* __restrict__ y,
                     long long nchunks, int K, bool vec) {
  __shared__ int win[2][kMaxWin];
  const int t = threadIdx.x;
  const int nwin = K < kMaxWin ? K : kMaxWin;
  long long c = blockIdx.x;   // the grid never exceeds nchunks
  float4 v;
  uint2 p;
  load_slots(vals, pidx, c * kChunk + 4 * t, vec, v, p);
  if (t < nwin) win[0][t] = __ldg(bids + c * K + t);
  __syncthreads();
  for (int buf = 0;; buf ^= 1) {
    const long long n = c + gridDim.x;
    const bool more = n < nchunks;   // the same for the whole CTA
    float4 vn = v;
    uint2 pn = p;
    int bn = 0;
    if (more) {
      load_slots(vals, pidx, n * kChunk + 4 * t, vec, vn, pn);
      if (t < nwin) bn = __ldg(bids + n * K + t);
    }
    const int* w = win[buf];
    const int q0 = p.x & 0xffff, q1 = p.x >> 16;
    const int q2 = p.y & 0xffff, q3 = p.y >> 16;
    const float x0 = __ldg(x + (size_t)w[q0 >> 7] * 128 + (q0 & 127));
    const float x1 = __ldg(x + (size_t)w[q1 >> 7] * 128 + (q1 & 127));
    const float x2 = __ldg(x + (size_t)w[q2 >> 7] * 128 + (q2 & 127));
    const float x3 = __ldg(x + (size_t)w[q3 >> 7] * 128 + (q3 & 127));
    emit<E>(v, x0, x1, x2, x3, y, c, t);
    if (!more) break;
    // win[buf ^ 1] was last read before the previous iteration's barrier
    if (t < nwin) win[buf ^ 1][t] = bn;
    __syncthreads();
    v = vn;
    p = pn;
    c = n;
  }
}

template <int E>
void launch(const float* vals, const short* pidx, const int* bids,
            const float* x, float* y, long long nchunks, int K, bool vec,
            cudaStream_t stream) {
  // as many CTAs as the card holds at once, and no more than chunks
  static int per_sm = 0;
  if (per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sell_spmv_f32_kernel<E>, kThreads, 0) != cudaSuccess ||
       per_sm < 1))
    per_sm = 1;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long grid = (long long)(sms > 0 ? sms : 1) * per_sm;
  if (grid > nchunks) grid = nchunks;
  sell_spmv_f32_kernel<E><<<(unsigned)grid, kThreads, 0, stream>>>(
      vals, pidx, bids, x, y, nchunks, K, vec);
}

}  // namespace

// y must hold nchunks * 8 * 128 / E values; E is a power of two <= 128.
extern "C" int fedd_sell_spmv_f32(const float* vals, const short* pidx,
                                  const int* bids, const float* x, float* y,
                                  long long nchunks, int K, int E,
                                  cudaStream_t stream) {
  if (E < 1 || E > 128 || (E & (E - 1)) != 0 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (nchunks > 0) {
    const bool vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(pidx) % 8 == 0;
    switch (E) {
      case 1: launch<1>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
      case 2: launch<2>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
      case 4: launch<4>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
      case 8: launch<8>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
      case 16: launch<16>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
      case 32: launch<32>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
      case 64: launch<64>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
      default: launch<128>(vals, pidx, bids, x, y, nchunks, K, vec, stream); break;
    }
  }
  return (int)cudaGetLastError();
}
