// Batched symmetric 3x3 eigendecomposition (kernel K1): the contract of
// torch.linalg.eigh on (N,3,3) float32 (the lower triangle is read),
// eigenvalues ascending (N,3) and eigenvectors as columns (N,3,3).
//
// Replaces no TPU kernel. The JAX package's estimate_normals calls
// jnp.linalg.eigh inside its jitted step; the port's torch.linalg.eigh on
// the card runs cuSOLVER, which reads a status on the host after every
// call and refuses batches of 32,768 matrices or more, so a step that
// calls it cannot be captured as a CUDA graph. This kernel reads nothing
// on the host and takes any N.
//
// Bound on the H100: bytes. A matrix reads 36 B and writes 48 B; the
// Jacobi sweeps cost about 150 float64 operations each, and the data
// converges in 3-5 of them. Design: one thread per matrix, cyclic Jacobi
// rotations on the (0,1), (0,2), (1,2) pairs in registers, in float64
// (the float32 input is exact in it, so the result is rounded once, at
// the store), at most MAX_SWEEPS sweeps, stopping once the squared
// off-diagonal norm falls below 1e-30 of the squared Frobenius norm (the
// float64 rounding floor). Then the columns are sorted by eigenvalue.
// `sweeps`, when given, receives each matrix's sweep count (the work this
// data needed, for the bound).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SWEEPS = 8;

// One Jacobi rotation zeroing a[p][q] (Golub and Van Loan, sym.schur2):
// A <- J^T A J, V <- V J, r the third index.
template <int p, int q, int r>
__device__ __forceinline__ void rotate(double (&a)[3][3], double (&v)[3][3]) {
  const double apq = a[p][q];
  if (apq == 0.0) return;
  const double tau = (a[q][q] - a[p][p]) / (2.0 * apq);
  // tau * tau overflows beyond 1e154; there t -> 1 / (2 tau)
  const double t = fabs(tau) > 1e150
                       ? 0.5 / tau
                       : (tau >= 0.0 ? 1.0 : -1.0) /
                             (fabs(tau) + sqrt(1.0 + tau * tau));
  const double c = rsqrt(1.0 + t * t);
  const double s = t * c;
  a[p][p] -= t * apq;
  a[q][q] += t * apq;
  a[p][q] = a[q][p] = 0.0;
  const double arp = a[r][p], arq = a[r][q];
  a[r][p] = a[p][r] = c * arp - s * arq;
  a[r][q] = a[q][r] = s * arp + c * arq;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double vp = v[k][p], vq = v[k][q];
    v[k][p] = c * vp - s * vq;
    v[k][q] = s * vp + c * vq;
  }
}

template <int i, int j>
__device__ __forceinline__ void order(double (&a)[3][3], double (&v)[3][3]) {
  if (a[j][j] < a[i][i]) {
    const double t = a[i][i];
    a[i][i] = a[j][j];
    a[j][j] = t;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double u = v[k][i];
      v[k][i] = v[k][j];
      v[k][j] = u;
    }
  }
}

__global__ void eig3(const float* __restrict__ A, float* __restrict__ w,
                     float* __restrict__ V, int* __restrict__ sweeps,
                     long long n) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  const float* x = A + 9 * m;
  double a[3][3], v[3][3];
  a[0][0] = x[0];
  a[1][1] = x[4];
  a[2][2] = x[8];
  a[0][1] = a[1][0] = x[3];
  a[0][2] = a[2][0] = x[6];
  a[1][2] = a[2][1] = x[7];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  const double diag2 = a[0][0] * a[0][0] + a[1][1] * a[1][1] +
                       a[2][2] * a[2][2];
  const double off2 = a[0][1] * a[0][1] + a[0][2] * a[0][2] +
                      a[1][2] * a[1][2];
  const double floor2 = 1e-30 * (diag2 + 2.0 * off2);
  int sweep = 0;
  for (; sweep < MAX_SWEEPS; ++sweep) {
    const double off = a[0][1] * a[0][1] + a[0][2] * a[0][2] +
                       a[1][2] * a[1][2];
    if (!(off > floor2)) break;
    rotate<0, 1, 2>(a, v);
    rotate<0, 2, 1>(a, v);
    rotate<1, 2, 0>(a, v);
  }
  order<0, 1>(a, v);
  order<1, 2>(a, v);
  order<0, 1>(a, v);
  float* wo = w + 3 * m;
  float* vo = V + 9 * m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    wo[i] = (float)a[i][i];
#pragma unroll
    for (int j = 0; j < 3; ++j) vo[3 * i + j] = (float)v[i][j];
  }
  if (sweeps != nullptr) sweeps[m] = sweep;
}

}  // namespace

extern "C" int repas_eig3(const void* A, void* w, void* V, void* sweeps,
                          long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int threads = 128;
  eig3<<<(unsigned)((n + threads - 1) / threads), threads, 0,
         (cudaStream_t)stream>>>((const float*)A, (float*)w, (float*)V,
                                 (int*)sweeps, n);
  return (int)cudaGetLastError();
}
