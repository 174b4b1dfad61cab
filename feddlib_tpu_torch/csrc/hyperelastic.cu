// Neo-Hooke P1 tetrahedron: internal forces and consistent tangent (f64).
//
// Replaces no Pallas kernel.  The JAX package differentiates the element
// energy with jax.grad / jax.hessian (feddlib_tpu/fe/hyperelastic.py:103
// elem_hyper_residual_tangent), and the port did the same with torch.func
// under vmap: hundreds of small per-op dispatches a chunk of elements, four
// identical quadrature points a tetrahedron (F is constant on a P1 element).
// This kernel evaluates the closed form of W = mu/2 (I1 - 3) - mu ln J +
// lam/2 (ln J)^2 for every element in one launch:
//   g_a = B^-T grad_xi phi_a,  vol = |det B| / 6,
//   F = I + sum_a d_a (x) g_a,  J = det F,  h_a = F^-T g_a,
//   R_(a,i) = vol [mu (F g_a)_i + (lam ln J - mu) h_(a,i)],
//   K_(a,i),(b,k) = vol [mu delta_ik (g_a . g_b) + lam h_(a,i) h_(b,k)
//                        + (mu - lam ln J) h_(a,k) h_(b,i)],
// in NodeWise order (row 3a + i), R [E, 12] and K [E, 12, 12], the layout of
// the torch.func path.  J <= 0 gives a non-finite R and K, as log does there.
// The plain version is fe/hyperelastic.py neo_hooke_p1_plain.
//
// Bound on the H100: bytes.  An element reads 24 doubles (vertex coordinates
// and nodal displacements, 192 B) and writes 12 + 144 (1,248 B), for some
// 400 f64 operations: at the 32^3 cube's 196,608 elements 283 MB, 0.085 ms at
// 3.35 TB/s, 80 % of it K; without the tangent 57 MB, 0.017 ms.
//
// Design.  One thread holding an element's 144 doubles would store them
// 1,152 B apart across a warp and spill registers.  So a block takes a tile
// of 288 elements in two phases.  Phase 1: one thread an element computes
// its scalars once (vol mu, vol lam, vol (mu - lam ln J)), h_a, the Gram
// matrix g_a . g_b (10 of 16) and R, and stages them in shared memory
// (85 KB a tile, two tiles an SM).  Phase 2: the 288 threads write the
// tile's K as consecutive 16-byte stores: thread t owns slot t % 72 (a
// fixed row and pair of columns) of elements t / 72, + 4, + 8, ..., so a
// warp's stores are 512 contiguous bytes and each thread decodes its
// (a, i, b, k) once.  R leaves the same way.  Every entry is computed by
// one fixed sequence of operations, so repeated calls are bitwise equal,
// and K is bitwise symmetric (the Gram matrix is stored once for a <= b
// and both h products commute).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 288;             // 4 elements' K slots a pass
constexpr int kTile = kThreads;           // elements a block, one a thread
constexpr int kSlots = 72;                // double2 of one element's K
constexpr int kStaged = 12 + 10 + 3 + 12; // h, Gram, scalars, R a element

__device__ __forceinline__ int gram_index(int a, int b) {
  // upper triangle of the symmetric 4 x 4 Gram matrix, row by row
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return lo * 4 - lo * (lo - 1) / 2 + (hi - lo);
}

__device__ __forceinline__ double det3(const double (&m)[3][3]) {
  return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
         m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
         m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

// cofactor inverse, as fe/assembly.py small_inv
__device__ __forceinline__ void inv3(const double (&m)[3][3], double det,
                                     double (&r)[3][3]) {
  const double s = 1.0 / det;
  r[0][0] = (m[1][1] * m[2][2] - m[1][2] * m[2][1]) * s;
  r[0][1] = (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * s;
  r[0][2] = (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * s;
  r[1][0] = (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * s;
  r[1][1] = (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * s;
  r[1][2] = (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * s;
  r[2][0] = (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * s;
  r[2][1] = (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * s;
  r[2][2] = (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * s;
}

// Phase 1 for element e: stage h, the Gram matrix, the three scalars and R.
template <bool kTangent>
__device__ __forceinline__ void element(const double* __restrict__ X,
                                        const double* __restrict__ D,
                                        double mu, double lam, double* h_out,
                                        double* gram_out, double* c_out,
                                        double* r_out) {
  double B[3][3], Bi[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double x0 = __ldg(X + i);
#pragma unroll
    for (int j = 0; j < 3; ++j) B[i][j] = __ldg(X + 3 * (j + 1) + i) - x0;
  }
  const double detB = det3(B);
  inv3(B, detB, Bi);
  // g_a = B^-T grad_xi phi_a: rows of B^-1, and minus their sum for a = 0
  double g[4][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g[1][k] = Bi[0][k];
    g[2][k] = Bi[1][k];
    g[3][k] = Bi[2][k];
    g[0][k] = -(Bi[0][k] + Bi[1][k] + Bi[2][k]);
  }
  const double vol = fabs(detB) / 6.0;
  double F[3][3], Fi[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) F[i][k] = i == k ? 1.0 : 0.0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double d = __ldg(D + 3 * a + i);
#pragma unroll
      for (int k = 0; k < 3; ++k) F[i][k] += d * g[a][k];
    }
  const double J = det3(F);
  inv3(F, J, Fi);
  const double lnJ = log(J);
  const double cm = vol * mu, cl = vol * lam, c3 = vol * (mu - lam * lnJ);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      double h = 0.0, fg = 0.0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        h += Fi[k][i] * g[a][k];
        fg += F[i][k] * g[a][k];
      }
      h_out[3 * a + i] = h;
      r_out[3 * a + i] = cm * fg - c3 * h;
    }
  if (kTangent) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a; b < 4; ++b)
        gram_out[gram_index(a, b)] =
            g[a][0] * g[b][0] + g[a][1] * g[b][1] + g[a][2] * g[b][2];
    c_out[0] = cm;
    c_out[1] = cl;
    c_out[2] = c3;
  }
}

template <bool kTangent>
__global__ void __launch_bounds__(kThreads, 2)
    neo_hooke_p1_kernel(const double* __restrict__ vc,
                        const double* __restrict__ de, double* __restrict__ R,
                        double* __restrict__ K, long long n_elem, double mu,
                        double lam) {
  extern __shared__ __align__(16) double smem[];
  double* s_h = smem;                  // [kTile][12]
  double* s_gram = s_h + kTile * 12;   // [kTile][10]
  double* s_c = s_gram + kTile * 10;   // [kTile][3]
  double* s_r = s_c + kTile * 3;       // [kTile][12]
  const long long base = (long long)blockIdx.x * kTile;
  const long long left = n_elem - base;
  const int n_here = left < kTile ? (int)left : kTile;
  const int t = threadIdx.x;
  if (t < n_here)
    element<kTangent>(vc + (base + t) * 12, de + (base + t) * 12, mu, lam,
                      s_h + t * 12, s_gram + t * 10, s_c + t * 3,
                      s_r + t * 12);
  __syncthreads();
  // R: the tile's n_here * 12 doubles are contiguous
  double2* R2 = reinterpret_cast<double2*>(R + base * 12);
  const double2* sr2 = reinterpret_cast<const double2*>(s_r);
  for (int q = t; q < n_here * 6; q += kThreads) R2[q] = sr2[q];
  if (!kTangent) return;
  // this thread's slot: row 3a + i, columns col and col + 1
  const int s = t % kSlots;
  const int row = s / 6, a = row / 3, i = row % 3;
  const int col = 2 * (s % 6);
  const int b0 = col / 3, k0 = col % 3, b1 = (col + 1) / 3, k1 = (col + 1) % 3;
  const int q0 = gram_index(a, b0), q1 = gram_index(a, b1);
  double2* K2 = reinterpret_cast<double2*>(K + base * 144);
  for (int el = t / kSlots; el < n_here; el += kThreads / kSlots) {
    const double* h = s_h + el * 12;
    const double* c = s_c + el * 3;
    const double cm = c[0], cl = c[1], c3 = c[2];
    const double hai = h[3 * a + i];
    double2 v;
    v.x = (i == k0 ? cm * s_gram[el * 10 + q0] : 0.0) +
          cl * (hai * h[3 * b0 + k0]) + c3 * (h[3 * a + k0] * h[3 * b0 + i]);
    v.y = (i == k1 ? cm * s_gram[el * 10 + q1] : 0.0) +
          cl * (hai * h[3 * b1 + k1]) + c3 * (h[3 * a + k1] * h[3 * b1 + i]);
    K2[el * kSlots + s] = v;
  }
}

template <bool kTangent>
int launch(const double* vc, const double* de, double* R, double* K,
           long long n_elem, double mu, double lam, cudaStream_t stream) {
  const auto kernel = neo_hooke_p1_kernel<kTangent>;
  const size_t smem = (size_t)kTile * kStaged * sizeof(double);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n_elem + kTile - 1) / kTile;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(vc, de, R, K, n_elem,
                                                       mu, lam);
  return (int)cudaGetLastError();
}

}  // namespace

// vc, de: [n_elem, 4, 3] f64 (vertex coordinates, nodal displacements);
// R [n_elem, 12]; K [n_elem, 12, 12], written only when tangent != 0 (may be
// null otherwise).  n_elem = 0 launches nothing.
extern "C" int fedd_neo_hooke_p1_f64(const double* vc, const double* de,
                                     double* R, double* K, long long n_elem,
                                     double mu, double lam, int tangent,
                                     cudaStream_t stream) {
  if (n_elem < 0 || (tangent && K == nullptr) ||
      (n_elem + kTile - 1) / kTile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_elem == 0) return (int)cudaGetLastError();
  return tangent ? launch<true>(vc, de, R, K, n_elem, mu, lam, stream)
                 : launch<false>(vc, de, R, K, n_elem, mu, lam, stream);
}
