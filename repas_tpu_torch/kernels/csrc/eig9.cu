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
// What bounds it on the H100: the chain of dependent float64 operations
// of its rotations, not the bytes (684 B a float32 matrix) nor the card's
// float64 rate. The path calls it on 1 and 16 matrices, where a few warps
// run on an idle card and each rotation's square roots and shuffles wait
// on the one before; a cyclic sweep is 36 such rotations in series, and
// the data needs 4-7 sweeps.
//
// Design: Jacobi in float64 (a float32 input is exact in it, so the
// result is rounded once, at the store) in parallel order. A round-robin
// tournament over ten indices, the nine rows and a dummy, splits each
// sweep into 9 rounds of 4 disjoint pairs: in round R, row k meets row
// (2R - k) mod 9 and row R sits out, so each of the 36 pairs comes once a
// sweep. The 4 rotations of a round commute, so a sweep is 9 dependent
// rotation steps instead of 36. Three matrices share a warp (lanes 0-8,
// 9-17 and 18-26; 27-31 idle), lane k of a matrix holding its row k of A
// and of V in registers. Per round: each lane fetches its partner's row
// by shuffles; the pair's lower lane alone computes the rotation
// (csrc/jacobi.cuh: two rsqrt, no division) and the other
// lanes read every pair's (c, s) by shuffles; each lane mixes its row
// with its partner's (J^T A), then its columns pair by pair (A J, and V
// J), and the pair's 2x2 block takes the rotation's Schur values with
// a_pq exactly 0. The matrix is first scaled by an even power of two
// (exact; the squares stay in range), undone on the eigenvalues. A
// matrix's sweeps stop once its squared off-diagonal norm falls below
// 1e-30 of its squared Frobenius norm (the float64 rounding floor), or
// after MAX_SWEEPS; its lanes then idle while the warp's other matrices
// go on, so a matrix's result does not depend on its neighbours. Only
// warp shuffles synchronise: a warp with no matrix returns at once, and
// no block-wide barrier exists. The columns are then sorted by eigenvalue
// (each lane's rank: the eigenvalues below it, ties by index; NaN sorts
// last). `sweeps`, when given, receives each matrix's sweep count.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "jacobi.cuh"

namespace {

constexpr int MAX_SWEEPS = 16;
constexpr int ROWS = 9;
constexpr int PER_WARP = 3;         // matrices a warp, 9 lanes each
constexpr int WARPS = 4;            // warps a block
constexpr unsigned FULL = 0xffffffffu;

// The sum and the max over the 9 lanes of a matrix, taken in one order in
// every lane, so that its lanes agree bit for bit.
__device__ __forceinline__ double group_sum(double x, int base) {
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) s += __shfl_sync(FULL, x, base + j);
  return s;
}

__device__ __forceinline__ double group_max(double x, int base) {
  double m = 0.0;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) m = fmax(m, __shfl_sync(FULL, x, base + j));
  return m;
}

// The pairs of round R: (R + i) mod 9 and (R - i) mod 9, i = 1..4 (pair
// I = i - 1), lower index first.
__host__ __device__ constexpr int pair_lo(int R, int I) {
  return (R + I + 1) % ROWS < (R + 2 * ROWS - I - 1) % ROWS
             ? (R + I + 1) % ROWS : (R + 2 * ROWS - I - 1) % ROWS;
}
__host__ __device__ constexpr int pair_hi(int R, int I) {
  return (R + I + 1) % ROWS < (R + 2 * ROWS - I - 1) % ROWS
             ? (R + 2 * ROWS - I - 1) % ROWS : (R + I + 1) % ROWS;
}

// One round: lane k of a matrix rotates with its partner row; r and v are
// its rows of A and V, d its diagonal entry a_kk.
template <int R>
__device__ __forceinline__ void jacobi_round(double (&r)[ROWS],
                                             double (&v)[ROWS], double& d,
                                             int k, int base, bool active) {
  const int pk = (2 * R + ROWS - k) % ROWS;   // k itself for row R
  double pr[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) pr[j] = __shfl_sync(FULL, r[j], base + pk);
  const double dq = __shfl_sync(FULL, d, base + pk);
  double apq = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k == pair_lo(R, i)) apq = r[pair_hi(R, i)];
  double c = 1.0, s = 0.0, ta = 0.0;
  if (active && k < pk) jacobi_rotation(d, dq, apq, c, s, ta);
  double cs[4], sn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cs[i] = __shfl_sync(FULL, c, base + pair_lo(R, i));
    sn[i] = __shfl_sync(FULL, s, base + pair_lo(R, i));
  }
  const double tq = __shfl_sync(FULL, ta, base + pk);
  if (!active) return;
  // rows: the lower row becomes c A_p - s A_q, the upper s A_p + c A_q
  double co = 1.0, so = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k == pair_lo(R, i)) {
      co = cs[i];
      so = -sn[i];
    } else if (k == pair_hi(R, i)) {
      co = cs[i];
      so = sn[i];
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) r[j] = fma(so, pr[j], co * r[j]);
  // columns, of A and of V
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double ap = r[pair_lo(R, i)], aq = r[pair_hi(R, i)];
    r[pair_lo(R, i)] = cs[i] * ap - sn[i] * aq;
    r[pair_hi(R, i)] = sn[i] * ap + cs[i] * aq;
    const double vp = v[pair_lo(R, i)], vq = v[pair_hi(R, i)];
    v[pair_lo(R, i)] = cs[i] * vp - sn[i] * vq;
    v[pair_hi(R, i)] = sn[i] * vp + cs[i] * vq;
  }
  // the pair's 2x2 block: the Schur values, a_pq exactly 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k == pair_lo(R, i)) {
      d -= ta;
      r[pair_lo(R, i)] = d;
      r[pair_hi(R, i)] = 0.0;
    } else if (k == pair_hi(R, i)) {
      d += tq;
      r[pair_hi(R, i)] = d;
      r[pair_lo(R, i)] = 0.0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
    eig9(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
         int* __restrict__ sweeps, long long n) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / ROWS;        // 3 for the idle lanes 27-31
  const int k = lane - ROWS * grp;
  const int base = ROWS * grp;
  const long long first =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * PER_WARP;
  if (first >= n) return;             // the whole warp
  const long long m = first + grp;
  const bool live = grp < PER_WARP && m < n;

  // row k from the lower triangle, mirrored
  const T* x = A + ROWS * ROWS * (live ? m : first);
  double r[ROWS], v[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    r[j] = live ? (double)(j <= k ? x[ROWS * k + j] : x[ROWS * j + k]) : 0.0;
    v[j] = j == k ? 1.0 : 0.0;
  }
  // scaled by 2^-e, e even, so that the largest |entry| lies in [1/4, 1)
  double mx = 0.0;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) mx = fmax(mx, fabs(r[j]));
  mx = group_max(mx, base);
  int e = 0;
  if (mx > 0.0 && mx <= DBL_MAX) {
    e = ilogb(mx) + 1;
    e += e & 1;
  }
  double own = 0.0, d = 0.0;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    r[j] = ldexp(r[j], -e);
    own = fma(r[j], r[j], own);
    if (j == k) d = r[j];
  }
  const double floor2 = 1e-30 * group_sum(own, base);

  int sweep = 0;
  bool active = live;
  for (;;) {
    double off = 0.0;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) off = fma(r[j], j == k ? 0.0 : r[j], off);
    off = group_sum(off, base);
    if (!(off > floor2) || sweep == MAX_SWEEPS) active = false;
    if (!__any_sync(FULL, active)) break;
    if (active) ++sweep;
    jacobi_round<0>(r, v, d, k, base, active);
    jacobi_round<1>(r, v, d, k, base, active);
    jacobi_round<2>(r, v, d, k, base, active);
    jacobi_round<3>(r, v, d, k, base, active);
    jacobi_round<4>(r, v, d, k, base, active);
    jacobi_round<5>(r, v, d, k, base, active);
    jacobi_round<6>(r, v, d, k, base, active);
    jacobi_round<7>(r, v, d, k, base, active);
    jacobi_round<8>(r, v, d, k, base, active);
  }

  // lane k's eigenvalue goes to column rank
  const double key = isnan(d) ? CUDART_INF : d;
  int rank = 0;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const double kj = __shfl_sync(FULL, key, base + j);
    rank += (kj < key || (kj == key && j < k)) ? 1 : 0;
  }
  int to[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) to[j] = __shfl_sync(FULL, rank, base + j);
  if (!live) return;
  w[ROWS * m + rank] = (T)ldexp(d, e);
  T* vo = V + ROWS * ROWS * m + ROWS * k;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) vo[to[j]] = (T)v[j];
  if (k == 0 && sweeps != nullptr) sweeps[m] = sweep;
}

}  // namespace

extern "C" int repas_eig9(const void* A, void* w, void* V, void* sweeps,
                          long long n, int is_double, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long per_block = (long long)PER_WARP * WARPS;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  if (is_double)
    eig9<double><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const double*)A, (double*)w, (double*)V, (int*)sweeps, n);
  else
    eig9<float><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const float*)A, (float*)w, (float*)V, (int*)sweeps, n);
  return (int)cudaGetLastError();
}
