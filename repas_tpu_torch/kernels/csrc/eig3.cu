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
// What bounds it on the H100: a matrix reads 36 B and writes 48 B, which
// at 3.35 TB/s is the least time; but the Jacobi sweeps cost about 40
// float64 instructions a rotation and 9-10 rotations a matrix, which an
// SM issues at half its float32 rate (square-root seeds and float64
// conversions at an eighth), each rotation a chain of dependent ones, so
// the rotations, not the bytes, set the time. Design: one thread per
// matrix, in tiles of 32 matrices a warp. Each warp copies its tile's
// 1,152 contiguous bytes into shared memory as 16-byte vectors (scalars
// where the input is not 16-byte aligned, and for a ragged last tile's
// remainder); each lane takes its matrix from there (a stride of 9
// words: no bank conflict), writes its eigenvalues and vectors back
// there, and the warp stores its 384 and 1,152 bytes as 16-byte vectors
// (likewise; csrc/warp_tile.cuh, shared with K2). Warps synchronise
// only among their own lanes, so a warp whose matrices need another
// sweep holds up no other. Cyclic Jacobi
// rotations on the (0,1), (0,2), (1,2) pairs in registers, in float64
// (the float32 input is exact in it, so the result is rounded once, at
// the store), each rotation two reciprocal square roots and no division
// (csrc/jacobi.cuh); a pair whose a_pq^2 is already at or under a third
// of the floor below is set to 0 and not rotated (in the last sweep most
// are); at most MAX_SWEEPS sweeps, stopping once the squared
// off-diagonal norm falls below 1e-30 of the squared Frobenius norm (the
// float64 rounding floor). Then the columns are sorted by eigenvalue.
// `sweeps`, when given, receives each matrix's sweep count (the work
// this data needed, for the bound).

#include <cuda_runtime.h>

#include "jacobi.cuh"
#include "warp_tile.cuh"

namespace {

constexpr int MAX_SWEEPS = 8;
constexpr int TILE = 32;            // matrices a warp's tile, one a lane
constexpr int WARPS = 4;            // warps a block

// One Jacobi rotation zeroing a[p][q]: A <- J^T A J, V <- V J, r the
// third index; an a[p][q] whose square is at or under floor2 / 3 is set
// to 0 without one (so a sweep of such pairs ends the loop).
template <int p, int q, int r>
__device__ __forceinline__ void rotate(double (&a)[3][3], double (&v)[3][3],
                                       double floor2) {
  double c, s, ta;
  if (!(3.0 * a[p][q] * a[p][q] > floor2) ||
      !jacobi_rotation(a[p][p], a[q][q], a[p][q], c, s, ta)) {
    a[p][q] = a[q][p] = 0.0;
    return;
  }
  a[p][p] -= ta;
  a[q][q] += ta;
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

__global__ void __launch_bounds__(32 * WARPS)
    eig3(const float* __restrict__ A, float* __restrict__ w,
         float* __restrict__ V, int* __restrict__ sweeps, long long n) {
  __shared__ float4 mat4[WARPS][9 * TILE / 4];   // matrices, then vectors
  __shared__ float4 val4[WARPS][3 * TILE / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile * TILE >= n) return;     // the whole warp: no block barrier
  const int nb = (int)(n - tile * TILE < TILE ? n - tile * TILE : TILE);
  float* mat = reinterpret_cast<float*>(mat4[warp]);
  float* val = reinterpret_cast<float*>(val4[warp]);
  warp_copy(mat, A + 9 * TILE * tile, 9 * nb, lane);
  __syncwarp();

  const bool live = lane < nb;
  const float* x = mat + 9 * lane;
  double a[3][3], v[3][3];
  a[0][0] = live ? x[0] : 0.0f;
  a[1][1] = live ? x[4] : 0.0f;
  a[2][2] = live ? x[8] : 0.0f;
  a[0][1] = a[1][0] = live ? x[3] : 0.0f;
  a[0][2] = a[2][0] = live ? x[6] : 0.0f;
  a[1][2] = a[2][1] = live ? x[7] : 0.0f;
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
    rotate<0, 1, 2>(a, v, floor2);
    rotate<0, 2, 1>(a, v, floor2);
    rotate<1, 2, 0>(a, v, floor2);
  }
  order<0, 1>(a, v);
  order<1, 2>(a, v);
  order<0, 1>(a, v);

  __syncwarp();                     // every lane's matrix read
  if (live) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      val[3 * lane + i] = (float)a[i][i];
#pragma unroll
      for (int j = 0; j < 3; ++j) mat[9 * lane + 3 * i + j] = (float)v[i][j];
    }
    if (sweeps != nullptr) sweeps[TILE * tile + lane] = sweep;
  }
  __syncwarp();
  warp_copy(V + 9 * TILE * tile, mat, 9 * nb, lane);
  warp_copy(w + 3 * TILE * tile, val, 3 * nb, lane);
}

}  // namespace

extern "C" int repas_eig3(const void* A, void* w, void* V, void* sweeps,
                          long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long blocks = ((n + TILE - 1) / TILE + WARPS - 1) / WARPS;
  eig3<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)A, (float*)w, (float*)V, (int*)sweeps, n);
  return (int)cudaGetLastError();
}
