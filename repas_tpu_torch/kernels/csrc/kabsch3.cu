// Batched Kabsch rotation from 3x3 cross-covariances (kernel K2): for
// each H (N,3,3) float32 with SVD H = U S V^T,
//   R = V diag(1, 1, sign det(V U^T)) U^T   (N,3,3) float32,
// what repas_tpu_torch/cloud/fpfh.py::_kabsch computes from H with
// torch.linalg.svd and torch.linalg.det.
//
// Replaces no TPU kernel. The JAX package's ransac_registration calls
// jnp.linalg.svd inside its jitted step; the port's torch.linalg.svd on
// the card runs cuSOLVER, which reads a status on the host, so a step
// that calls it cannot be captured as a CUDA graph. This kernel reads
// nothing on the host.
//
// What bounds it on the H100: a matrix reads 36 B and writes 36 B, and
// the function needs about 620 float64 operations, so bytes set the
// least time (0.18 us at 8,192 matrices), far under a launch. The
// callers hand it 1-8,192 matrices: under two warps an SM, so nothing
// hides latency, and the time is one thread's chain of dependent float64
// instructions plus the launch. Design: shorten that chain. One thread
// per matrix (spreading a matrix over lanes would add shuffles to a chain
// whose arithmetic is short), in tiles of 32 matrices a warp: each warp
// copies its tile's 1,152 contiguous bytes into shared memory as 16-byte
// vectors and stores its results the same way (csrc/warp_tile.cuh, as K1;
// scalars for a ragged last tile or an unaligned pointer), each lane
// reading its matrix at a stride of 9 words (no bank conflict).
// One-sided (Hestenes) Jacobi in float64 in registers (the float32 input
// is exact in it, so the result is rounded once, at the store): the
// column pairs (0,1), (0,2), (1,2) of H in turn, each rotated by the
// rotation that diagonalises its 2x2 Gram block [[a, g], [g, b]] (a, b
// the squared column norms, g their dot product; csrc/jacobi.cuh, as K1
// and K3: two reciprocal square roots, no division), accumulated into V.
// A pair with g^2 <= 1e-30 a b (orthogonal to 1e-15 of its norms; no
// square root in the test) is not rotated; the loop stops after a sweep
// that rotates nothing, or at MAX_SWEEPS. The columns of H V are then
// S U; they are sorted by squared norm x_j and u_j = h_j rsqrt(x_j), so
// the singular values are never formed and nothing divides. For a point
// triple H has rank 2 at most, so its third column is rounding noise and
// is never normalised: u3 = u1 x u2. Where x2 <= 1e-26 x1 (sigma2 is
// noise: a collinear triple) u2 is any unit vector normal to u1, taken
// from the axis u1 leans on least; H = 0 gives R = I. R does not depend
// on the signs of u3 and v3: det(V U^T) flips with either. `sweeps`,
// when given, receives each matrix's count of sweeps that rotated.

#include <cuda_runtime.h>

#include "jacobi.cuh"
#include "warp_tile.cuh"

namespace {

constexpr int MAX_SWEEPS = 10;
constexpr int TILE = 32;            // matrices a warp's tile, one a lane
constexpr int WARPS = 4;            // warps a block

// Rotates columns p, q of h (and of v) to orthogonality; false when they
// already were.
template <int p, int q>
__device__ __forceinline__ bool rotate(double (&h)[3][3], double (&v)[3][3]) {
  double a = 0.0, b = 0.0, g = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a += h[k][p] * h[k][p];
    b += h[k][q] * h[k][q];
    g += h[k][p] * h[k][q];
  }
  double c, s, ta;
  if (!(g * g > 1e-30 * a * b) || !jacobi_rotation(a, b, g, c, s, ta))
    return false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double hp = h[k][p], hq = h[k][q];
    h[k][p] = c * hp - s * hq;
    h[k][q] = s * hp + c * hq;
    const double vp = v[k][p], vq = v[k][q];
    v[k][p] = c * vp - s * vq;
    v[k][q] = s * vp + c * vq;
  }
  return true;
}

template <int i, int j>
__device__ __forceinline__ void order(double (&x)[3], double (&h)[3][3],
                                      double (&v)[3][3]) {
  if (x[j] > x[i]) {
    const double t = x[i];
    x[i] = x[j];
    x[j] = t;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double u = h[k][i];
      h[k][i] = h[k][j];
      h[k][j] = u;
      u = v[k][i];
      v[k][i] = v[k][j];
      v[k][j] = u;
    }
  }
}

__device__ __forceinline__ double det3(const double (&m)[3][3]) {
  return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
         m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
         m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

__global__ void __launch_bounds__(32 * WARPS)
    kabsch3(const float* __restrict__ H, float* __restrict__ R,
            int* __restrict__ sweeps, long long n) {
  __shared__ float4 mat4[WARPS][9 * TILE / 4];   // H, then R
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile * TILE >= n) return;     // the whole warp: no block barrier
  const int nb = (int)(n - tile * TILE < TILE ? n - tile * TILE : TILE);
  float* mat = reinterpret_cast<float*>(mat4[warp]);
  warp_copy(mat, H + 9 * TILE * tile, 9 * nb, lane);
  __syncwarp();

  const bool live = lane < nb;
  const float* x = mat + 9 * lane;
  double h[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      h[i][j] = live ? x[3 * i + j] : 0.0f;
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  int sweep = 0;
  for (; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = rotate<0, 1>(h, v);
    rotated |= rotate<0, 2>(h, v);
    rotated |= rotate<1, 2>(h, v);
    if (!rotated) break;
  }
  double sq[3];                     // squared column norms: sigma^2
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sq[j] = h[0][j] * h[0][j] + h[1][j] * h[1][j] + h[2][j] * h[2][j];
  order<0, 1>(sq, h, v);
  order<1, 2>(sq, h, v);
  order<0, 1>(sq, h, v);

  double u[3][3];  // columns u1, u2, u3
  if (sq[0] > 0.0) {
    const double inv = rsqrt(sq[0]);
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k][0] = h[k][0] * inv;
  } else {  // H = 0: U = V = I, R = I
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) u[i][j] = v[i][j] = i == j ? 1.0 : 0.0;
  }
  if (sq[0] > 0.0 && sq[1] > 1e-26 * sq[0]) {   // sigma2 > 1e-13 sigma1
    const double inv = rsqrt(sq[1]);
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k][1] = h[k][1] * inv;
  } else if (sq[0] > 0.0) {
    // any unit vector normal to u1: u1 x e, e the axis u1 leans on least
    const double ax = fabs(u[0][0]), ay = fabs(u[1][0]), az = fabs(u[2][0]);
    const int e = ax <= ay && ax <= az ? 0 : (ay <= az ? 1 : 2);
    double c0 = e == 0 ? 0.0 : (e == 1 ? -u[2][0] : u[1][0]);
    double c1 = e == 0 ? u[2][0] : (e == 1 ? 0.0 : -u[0][0]);
    double c2 = e == 0 ? -u[1][0] : (e == 1 ? u[0][0] : 0.0);
    const double inv = rsqrt(c0 * c0 + c1 * c1 + c2 * c2);
    u[0][1] = c0 * inv;
    u[1][1] = c1 * inv;
    u[2][1] = c2 * inv;
  }
  u[0][2] = u[1][0] * u[2][1] - u[2][0] * u[1][1];
  u[1][2] = u[2][0] * u[0][1] - u[0][0] * u[2][1];
  u[2][2] = u[0][0] * u[1][1] - u[1][0] * u[0][1];
  const double d = det3(v) * det3(u) < 0.0 ? -1.0 : 1.0;

  __syncwarp();                     // every lane's matrix read
  if (live) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        mat[9 * lane + 3 * i + j] =
            (float)(v[i][0] * u[j][0] + v[i][1] * u[j][1] +
                    d * v[i][2] * u[j][2]);
    if (sweeps != nullptr) sweeps[TILE * tile + lane] = sweep;
  }
  __syncwarp();
  warp_copy(R + 9 * TILE * tile, mat, 9 * nb, lane);
}

}  // namespace

extern "C" int repas_kabsch3(const void* H, void* R, void* sweeps,
                             long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long blocks = ((n + TILE - 1) / TILE + WARPS - 1) / WARPS;
  kabsch3<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)H, (float*)R, (int*)sweeps, n);
  return (int)cudaGetLastError();
}
