// Batched symmetric 9x9 eigendecomposition (kernel K3): the contract of
// torch.linalg.eigh on (N,9,9) float32 or float64 (the lower triangle is
// read), eigenvalues ascending (N,9) and eigenvectors as columns (N,9,9),
// in the input's type.
//
// Replaces no TPU kernel. The JAX package's solve_pnp_sqpnp calls
// jnp.linalg.eigh on its 9x9 Omega and jnp.linalg.svd on its homography
// DLT inside its jitted step; the port's torch.linalg.eigh and svd on the
// card run cuSOLVER, which reads a status on the host after every call,
// so a step that calls them cannot be captured as a CUDA graph. This
// kernel reads nothing on the host. The DLT's null vector is the
// eigenvector of the smallest eigenvalue of its 9x9 Gram matrix, which
// the port forms in float64 and hands to the float64 entry.
//
// Bound on the H100: operations. A matrix reads 324 B (float32) and
// writes 360 B; a sweep costs about 4,300 float64 operations (36
// rotations, each about 115 over the rows and the eigenvector rows) and
// the data converges in 6-10 sweeps. Design: one warp per matrix, its
// first 9 lanes one row each; the matrix in shared memory, each lane's
// row of V in registers. Cyclic Jacobi in float64 (the float32 input is
// exact in it, so the result is rounded once, at the store): the 36
// (p,q) pairs of a sweep are unrolled, so p and q are constants; for each
// pair every lane reads a_pp, a_qq and a_pq, computes the rotation
// (Golub and Van Loan, sym.schur2), and lane k updates a_kp, a_kq and
// their mirrors and its row of V; a_pq is set to 0. The sweeps stop once
// the squared off-diagonal norm (a warp reduction) falls below 1e-30 of
// the squared Frobenius norm (the float64 rounding floor), or after
// MAX_SWEEPS. The columns are then sorted by eigenvalue (each lane's
// rank: the eigenvalues below it, ties by index; NaN sorts last).
// `sweeps`, when given, receives each matrix's sweep count (the work this
// data needed, for the bound).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_SWEEPS = 16;
constexpr int WARPS = 4;            // matrices per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
    eig9(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
         int* __restrict__ sweeps, long long n) {
  __shared__ double S_all[WARPS][81];
  __shared__ int rank_all[WARPS][9];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * WARPS + warp;
  if (m >= n) return;               // the whole warp: no block barrier
  double* S = S_all[warp];
  int* rank = rank_all[warp];
  const bool row = lane < 9;
  const int k = row ? lane : 0;

  // the lower triangle, mirrored
  const T* x = A + 81 * m;
  double v[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    if (row) S[9 * k + j] = (double)(j <= k ? x[9 * k + j] : x[9 * j + k]);
    v[j] = j == k ? 1.0 : 0.0;
  }
  __syncwarp();

  double own = 0.0;
#pragma unroll
  for (int j = 0; j < 9; ++j) own += row ? S[9 * k + j] * S[9 * k + j] : 0.0;
  const double floor2 = 1e-30 * warp_sum(own);

  int sweep = 0;
  for (; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int j = 0; j < 9; ++j)
      off += (row && j != k) ? S[9 * k + j] * S[9 * k + j] : 0.0;
    if (!(warp_sum(off) > floor2)) break;   // the same in every lane
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int q = p + 1; q < 9; ++q) {
        const double apq = S[9 * p + q];
        if (apq == 0.0) continue;           // the same in every lane
        const double app = S[9 * p + p], aqq = S[9 * q + q];
        const double tau = (aqq - app) / (2.0 * apq);
        // tau * tau overflows beyond 1e154; there t -> 1 / (2 tau)
        const double t = fabs(tau) > 1e150
                             ? 0.5 / tau
                             : (tau >= 0.0 ? 1.0 : -1.0) /
                                   (fabs(tau) + sqrt(1.0 + tau * tau));
        const double c = rsqrt(1.0 + t * t);
        const double s = t * c;
        const double akp = S[9 * k + p], akq = S[9 * k + q];
        __syncwarp();                       // every read before any write
        if (row) {
          if (k == p) {
            S[9 * p + p] = app - t * apq;
          } else if (k == q) {
            S[9 * q + q] = aqq + t * apq;
            S[9 * p + q] = S[9 * q + p] = 0.0;
          } else {
            const double np = c * akp - s * akq, nq = s * akp + c * akq;
            S[9 * k + p] = S[9 * p + k] = np;
            S[9 * k + q] = S[9 * q + k] = nq;
          }
          const double vp = v[p], vq = v[q];
          v[p] = c * vp - s * vq;
          v[q] = s * vp + c * vq;
        }
        __syncwarp();
      }
    }
  }

  // lane k's eigenvalue goes to column rank[k]
  if (row) {
    const double wk = S[9 * k + k];
    const double key = isnan(wk) ? CUDART_INF : wk;
    int r = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const double wj = S[9 * j + j];
      const double kj = isnan(wj) ? CUDART_INF : wj;
      r += (kj < key || (kj == key && j < k)) ? 1 : 0;
    }
    rank[k] = r;
    w[9 * m + r] = (T)wk;
  }
  __syncwarp();
  if (row) {
    T* vo = V + 81 * m + 9 * k;
#pragma unroll
    for (int j = 0; j < 9; ++j) vo[rank[j]] = (T)v[j];
  }
  if (lane == 0 && sweeps != nullptr) sweeps[m] = sweep;
}

}  // namespace

extern "C" int repas_eig9(const void* A, void* w, void* V, void* sweeps,
                          long long n, int is_double, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  if (is_double)
    eig9<double><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const double*)A, (double*)w, (double*)V, (int*)sweeps, n);
  else
    eig9<float><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const float*)A, (float*)w, (float*)V, (int*)sweeps, n);
  return (int)cudaGetLastError();
}
