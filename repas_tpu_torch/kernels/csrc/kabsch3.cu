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
// Bound on the H100: bytes (36 B read and 36 B written a matrix); a
// sweep costs about 200 float64 operations. Design: one thread per
// matrix, one-sided (Hestenes) Jacobi in float64 in registers: rotations
// of column pairs of H, accumulated into V, until every pair is
// orthogonal to 1e-15 of its norms (at most MAX_SWEEPS sweeps). The
// columns of H V are then S U; they are sorted by norm, u1 and u2
// normalised, and u3 = u1 x u2. For a point triple H has rank 2 at most,
// so its third column is rounding noise and is never normalised; where
// sigma2 is noise too (a collinear triple) u2 is any unit vector normal
// to u1. R does not depend on the signs of u3 and v3: det(V U^T) flips
// with either. `sweeps`, when given, receives each matrix's sweep count.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SWEEPS = 10;

// Rotates columns p, q of h (and of v) to orthogonality; false when they
// already were.
template <int p, int q>
__device__ __forceinline__ bool rotate(double (&h)[3][3], double (&v)[3][3]) {
  double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    alpha += h[k][p] * h[k][p];
    beta += h[k][q] * h[k][q];
    gamma += h[k][p] * h[k][q];
  }
  if (!(fabs(gamma) > 1e-15 * sqrt(alpha * beta))) return false;
  const double zeta = (beta - alpha) / (2.0 * gamma);
  const double t = fabs(zeta) > 1e150
                       ? 0.5 / zeta
                       : (zeta >= 0.0 ? 1.0 : -1.0) /
                             (fabs(zeta) + sqrt(1.0 + zeta * zeta));
  const double c = rsqrt(1.0 + t * t);
  const double s = t * c;
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
__device__ __forceinline__ void order(double (&sig)[3], double (&h)[3][3],
                                      double (&v)[3][3]) {
  if (sig[j] > sig[i]) {
    const double t = sig[i];
    sig[i] = sig[j];
    sig[j] = t;
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

__global__ void kabsch3(const float* __restrict__ H, float* __restrict__ R,
                        int* __restrict__ sweeps, long long n) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  const float* x = H + 9 * m;
  double h[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      h[i][j] = x[3 * i + j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  int sweep = 0;
  for (; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = rotate<0, 1>(h, v);
    rotated |= rotate<0, 2>(h, v);
    rotated |= rotate<1, 2>(h, v);
    if (!rotated) break;
  }
  double sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrt(h[0][j] * h[0][j] + h[1][j] * h[1][j] + h[2][j] * h[2][j]);
  order<0, 1>(sig, h, v);
  order<1, 2>(sig, h, v);
  order<0, 1>(sig, h, v);

  double u[3][3];  // columns u1, u2, u3
  if (sig[0] > 0.0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k][0] = h[k][0] / sig[0];
  } else {  // H = 0: U = V = I, R = I
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) u[i][j] = v[i][j] = i == j ? 1.0 : 0.0;
  }
  if (sig[0] > 0.0 && sig[1] > 1e-13 * sig[0]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k][1] = h[k][1] / sig[1];
  } else if (sig[0] > 0.0) {
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
  float* out = R + 9 * m;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = (float)(v[i][0] * u[j][0] + v[i][1] * u[j][1] +
                               d * v[i][2] * u[j][2]);
  if (sweeps != nullptr) sweeps[m] = sweep;
}

}  // namespace

extern "C" int repas_kabsch3(const void* H, void* R, void* sweeps,
                             long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int threads = 128;
  kabsch3<<<(unsigned)((n + threads - 1) / threads), threads, 0,
            (cudaStream_t)stream>>>((const float*)H, (float*)R, (int*)sweeps,
                                    n);
  return (int)cudaGetLastError();
}
