// Permutation gather y[i] = idx[i] >= 0 ? x[idx[i]] : 0 (f32).
//
// Replaces the TPU kernel feddlib_tpu/la/permute.py:_permute_pallas (kernel
// body _make_kernel).  That kernel needed a window plan (8 or 16 column
// windows of 128 lanes per output chunk, int16 lane indices, a 0/1 mask and
// a scatter tail for spilled outputs) because a TPU gathers only inside a
// 128-lane register.  A Hopper thread can load any address, so the plan is
// just the flat int32 index vector and each thread writes one output.
//
// Bound on the H100: bytes.  Each output reads 4 B of index and one 4 B
// value of x and writes 4 B, with no arithmetic.  The index and output
// streams are coalesced; the x reads are scattered but land on the 50 MB L2
// for the vector sizes of the padded-cluster solve, so the kernel runs at
// a fraction of the 3.35 TB/s stream rate set by the index and output.
#include <cuda_runtime.h>

namespace {

__global__ void permute_gather_f32_kernel(const float* __restrict__ x,
                                          const int* __restrict__ idx,
                                          float* __restrict__ y,
                                          long long n_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n_out; i += stride) {
    const int j = __ldg(idx + i);
    y[i] = j >= 0 ? __ldg(x + j) : 0.0f;
  }
}

}  // namespace

extern "C" int fedd_permute_gather_f32(const float* x, const int* idx,
                                       float* y, long long n_out,
                                       cudaStream_t stream) {
  if (n_out > 0) {
    const int threads = 256;
    long long blocks = (n_out + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
    permute_gather_f32_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        x, idx, y, n_out);
  }
  return (int)cudaGetLastError();
}
