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
// the 50 MB L2, so the kernel is a device-memory stream.  Design: one block
// of 8 warps per tile of 64 rows of one cluster; x[p] is staged once in
// shared memory; each warp walks its rows with 16-byte loads (4 f32 or 8
// bf16 per lane, neighbouring lanes on neighbouring addresses) and reduces
// the row with warp shuffles.
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

__global__ void dense_gemv_bf16_kernel(const __nv_bfloat16* __restrict__ blocks,
                                       const float* __restrict__ xs,
                                       float* __restrict__ y, int P, int R,
                                       int W, int tiles, bool vec) {
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
    if (vec) {
      const uint4* row8 = reinterpret_cast<const uint4*>(row);
      const int W8 = W >> 3;
      for (int i = lane; i < W8; i += 32) {
        const uint4 u = __ldg(row8 + i);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
        const float* xb = xsh + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = fmaf(__bfloat162float(h[j]), xb[j], acc);
      }
    } else {
      for (int i = lane; i < W; i += 32)
        acc = fmaf(__bfloat162float(row[i]), xsh[i], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) y[(size_t)p * R + r] = acc;
  }
}

template <typename Kernel, typename T>
int launch(Kernel kernel, const T* blocks, const float* xs, float* y, int P,
           int R, int W, int vec_elems, cudaStream_t stream) {
  if (P <= 0 || R <= 0) return (int)cudaGetLastError();
  const size_t smem = ((size_t)W * sizeof(float) + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = (W % vec_elems == 0) &&
                   (reinterpret_cast<uintptr_t>(blocks) % 16 == 0);
  const int tiles = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long grid = (long long)P * tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kWarps * 32, smem, stream>>>(blocks, xs, y, P, R,
                                                        W, tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fedd_dense_gemv_f32(const float* blocks, const float* xs,
                                   float* y, int P, int R, int W,
                                   cudaStream_t stream) {
  return launch(dense_gemv_f32_kernel, blocks, xs, y, P, R, W, 4, stream);
}

extern "C" int fedd_dense_gemv_bf16(const __nv_bfloat16* blocks,
                                    const float* xs, float* y, int P, int R,
                                    int W, cudaStream_t stream) {
  return launch(dense_gemv_bf16_kernel, blocks, xs, y, P, R, W, 8, stream);
}
