// Block-SELL SpMV, f32, over d x d node blocks on planar vectors, on the
// sliced, length-sorted layout of la/sell.py:SlicePlan:
//   y[ci, row_of[i]] = sum_t sum_cj hvals[t, ci*d + cj, l] * x[cj, col]
// with col = hcols[t, l], over the columns t of the slice s = i / 32 that
// holds sorted row i, and l = i % 32.
//
// Replaces the TPU kernel feddlib_tpu/la/sell.py:_block_sell_mv_pallas
// (kernel body _make_block_kernel).  The TPU kernel read [nchunks, d*d, 8,
// 128] planes that pad every node row to E slots; on the P2 elasticity
// residue (E = 64, rows of 20 occupied slots on average) two thirds of those
// bytes are zeros.  The host (SlicePlan) sorts the rows by occupied length
// within windows of 1,024 rows and cuts them into slices of 32 rows, each as
// wide as its longest row, so the padding left is a few per cent:
//   hvals     [n_cols, d*d, 32] f32: column t of a slice, one 128 B line per
//             block entry (lane l = the slice's l-th row);
//   hcols     [n_cols, 32] int32: the node column of each entry (0 for
//             padding, whose values are 0);
//   slice_ptr [nslices + 1] int64: slice s owns columns slice_ptr[s] ..
//             slice_ptr[s+1]-1;
//   row_of    [n_rows] int32: the original row of each sorted row;
//   x         [d, x_stride] f32 planar (component cj at cj*x_stride);
//   y         [d, n_rows] f32 planar.
// The COO spill stays outside the kernel (torch), as it is plain XLA in JAX.
//
// Bound on the H100: bytes.  Per column entry d*d*4 B of values and 4 B of
// column stream in once for 2*d*d operations; x (a few MB) is gathered
// through L1/L2.  Design: one thread a sorted row, one warp a slice, so every
// value and column load is one coalesced 128 B line.  A CTA is that one warp:
// slice widths differ up to 6x, and a CTA of 8 warps held its slot until its
// longest slice was done (0.102 ms against 0.080 at phase 5 on the H100), so
// the block scheduler balances warps directly, and the host orders the
// slices widest first.  A thread keeps d partial sums in registers (no
// shuffles) and takes its columns four at a time: the step's columns,
// values and x are loaded before its multiply-adds.  Values and columns are
// read once, with evict-first loads (9 % faster on the H100 than plain
// loads), x through the read-only path.  Each row's y is written once, zero
// for an empty row.
// d = 2 and 3 are unrolled; any other d runs a loop over ci that re-reads
// the (cached) columns.  True f32 FMAs on the CUDA cores: no TF32.
#include <cuda_runtime.h>

namespace {

constexpr int kSliceRows = 32;
constexpr int kUnroll = 4;

template <int D>
__device__ __forceinline__ void gather_fma(const float* __restrict__ vp,
                                           const float* __restrict__ x,
                                           long long x_stride, int col,
                                           float (&acc)[D]) {
  float xv[D];
#pragma unroll
  for (int cj = 0; cj < D; ++cj) xv[cj] = __ldg(x + cj * x_stride + col);
#pragma unroll
  for (int ci = 0; ci < D; ++ci)
#pragma unroll
    for (int cj = 0; cj < D; ++cj)
      acc[ci] = fmaf(__ldcs(vp + (ci * D + cj) * kSliceRows), xv[cj], acc[ci]);
}

// d == D, unrolled; one warp a CTA, slice blockIdx.x (+ gridDim.x ...).
template <int D>
__global__ void __launch_bounds__(kSliceRows)
block_sell_slices_kernel(const float* __restrict__ hvals,
                         const int* __restrict__ hcols,
                         const long long* __restrict__ slice_ptr,
                         const int* __restrict__ row_of,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long n_rows, long long nslices,
                         long long x_stride) {
  constexpr int DD = D * D;
  const int lane = threadIdx.x;
  for (long long s = blockIdx.x; s < nslices; s += gridDim.x) {
    const long long t0 = __ldg(slice_ptr + s);
    const int w = (int)(__ldg(slice_ptr + s + 1) - t0);
    const int* cp = hcols + t0 * kSliceRows + lane;
    const float* vp = hvals + t0 * DD * kSliceRows + lane;
    float acc[D];
#pragma unroll
    for (int ci = 0; ci < D; ++ci) acc[ci] = 0.0f;
    int t = 0;
    for (; t + kUnroll <= w; t += kUnroll) {
      int col[kUnroll];
      float v[kUnroll][DD], xv[kUnroll][D];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        col[u] = __ldcs(cp + (t + u) * kSliceRows);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int q = 0; q < DD; ++q)
          v[u][q] = __ldcs(vp + ((long long)(t + u) * DD + q) * kSliceRows);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int cj = 0; cj < D; ++cj)
          xv[u][cj] = __ldg(x + cj * x_stride + col[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int ci = 0; ci < D; ++ci)
#pragma unroll
          for (int cj = 0; cj < D; ++cj)
            acc[ci] = fmaf(v[u][ci * D + cj], xv[u][cj], acc[ci]);
    }
    for (; t < w; ++t)
      gather_fma<D>(vp + (long long)t * DD * kSliceRows, x, x_stride,
                    __ldcs(cp + t * kSliceRows), acc);
    const long long i = s * kSliceRows + lane;
    if (i < n_rows) {
      const int r = __ldg(row_of + i);
#pragma unroll
      for (int ci = 0; ci < D; ++ci) y[ci * n_rows + r] = acc[ci];
    }
  }
}

// Any d: one output component at a time.
__global__ void __launch_bounds__(kSliceRows)
block_sell_slices_any_kernel(const float* __restrict__ hvals,
                             const int* __restrict__ hcols,
                             const long long* __restrict__ slice_ptr,
                             const int* __restrict__ row_of,
                             const float* __restrict__ x,
                             float* __restrict__ y, long long n_rows,
                             long long nslices, int d, long long x_stride) {
  const int lane = threadIdx.x;
  const long long dd = (long long)d * d;
  for (long long s = blockIdx.x; s < nslices; s += gridDim.x) {
    const long long t0 = __ldg(slice_ptr + s);
    const int w = (int)(__ldg(slice_ptr + s + 1) - t0);
    const int* cp = hcols + t0 * kSliceRows + lane;
    const float* vp = hvals + t0 * dd * kSliceRows + lane;
    const long long i = s * kSliceRows + lane;
    const int r = i < n_rows ? __ldg(row_of + i) : 0;
    for (int ci = 0; ci < d; ++ci) {
      float acc = 0.0f;
      for (int t = 0; t < w; ++t) {
        const int col = __ldg(cp + t * kSliceRows);
        const float* v = vp + ((long long)t * dd + ci * d) * kSliceRows;
        for (int cj = 0; cj < d; ++cj)
          acc = fmaf(__ldg(v + cj * kSliceRows),
                     __ldg(x + cj * x_stride + col), acc);
      }
      if (i < n_rows) y[ci * n_rows + r] = acc;
    }
  }
}



}  // namespace

// y holds d * n_rows values; slice_ptr nslices + 1 = ceil(n_rows / 32) + 1
// entries; every hcols entry is < x_stride.
extern "C" int fedd_block_sell_slices_f32(
    const float* hvals, const int* hcols, const long long* slice_ptr,
    const int* row_of, const float* x, float* y, long long n_rows,
    long long nslices, int d, long long x_stride, cudaStream_t stream) {
  if (d < 1 || x_stride < 1 || n_rows < 0 ||
      nslices != (n_rows + kSliceRows - 1) / kSliceRows)
    return (int)cudaErrorInvalidValue;
  if (nslices > 0) {
    const unsigned grid = (unsigned)(nslices < (1LL << 30) ? nslices
                                                           : (1LL << 30));
    switch (d) {
      case 2:
        block_sell_slices_kernel<2><<<grid, kSliceRows, 0, stream>>>(
            hvals, hcols, slice_ptr, row_of, x, y, n_rows, nslices, x_stride);
        break;
      case 3:
        block_sell_slices_kernel<3><<<grid, kSliceRows, 0, stream>>>(
            hvals, hcols, slice_ptr, row_of, x, y, n_rows, nslices, x_stride);
        break;
      default:
        block_sell_slices_any_kernel<<<grid, kSliceRows, 0, stream>>>(
            hvals, hcols, slice_ptr, row_of, x, y, n_rows, nslices, d,
            x_stride);
        break;
    }
  }
  return (int)cudaGetLastError();
}
