// Grid-hash 1-NN query (kernel K4): for each query point, the nearest
// target point among the slots of the 27 grid cells around the query's
// cell, what repas_tpu_torch/cloud/knn.py::grid_hash_query_plain
// computes, bit for bit:
//   - the query's cell as _cell_ijk: (q - origin) / cell in float32
//     (IEEE division), floor, clamped to [0, dims-1], then an integer; a
//     query beyond the extent searches the boundary cells; a query with
//     a NaN coordinate has no candidate (the plain clamp keeps the NaN,
//     whose integer conversion puts every neighbour outside the grid),
//     so no read leaves the table;
//   - candidate columns offset * slots + slot, the 27 offsets dx-major,
//     as _candidate_indices; a neighbour cell outside the grid, or an
//     empty slot, is no candidate;
//   - the squared distance ((dx dx + dy dy) + dz dz) on d = t - q in
//     float32, each operation rounded (no FMA contraction);
//   - the first column of least distance, as torch.argmin: a NaN beats
//     any number and the first NaN wins; where every distance is
//     infinite the winner is column 0, which may hold a point;
//   - idx -1 and dist inf unless the query is masked in and the winner
//     holds a point; else dist = sqrt of its squared distance, correctly
//     rounded.
// The filled slots of a cell are a prefix (grid_hash_build's pass s takes
// a cell's s-th highest index), so a cell's scan stops at its first empty
// slot.
//
// Replaces no TPU kernel. The JAX package's grid_hash_query is jax.jit
// code (XLA fuses the gather, the distances and the argmin); the port's
// plain version runs it in chunks of 16,384 rows, each writing its
// (rows, 27 * slots) candidate block to device memory and running about
// 45 elementwise, gather and reduction kernels on it.
//
// What bounds it on the H100: one query reads 12 B and its mask and
// writes 8 B, and the table and the target are read once: 47-59 MB at
// ICP's 921,600-point shapes, 0.014-0.018 ms at 3.35 TB/s. But a query
// reads 27 * slots candidates, each an index and a 12-byte target point
// wherever the grid put it: 432 a query on ICP's coarse level, 216 on
// its fine one, 0.6 G reads a pass. Both tables fit the 50 MB L2, so the
// candidates' sectors, served from L1 and L2, set the time. Design: eight
// lanes a query, lane l taking slots l, l + 8, ... of each cell in
// column order and keeping its own best (distance, column, point), the
// eight then reduced by shuffles on (distance, column), so the first
// column still wins; the table read through its strides, so that a
// (cells, slots) copy of it (cloud.knn.grid2_build makes one a grid)
// puts a cell's slots side by side and one query's eight lanes read them
// in one or two sectors. Measured at ICP's shapes (H100, coarse / fine):
// a thread a query on the (slots, cells) table 2.40 / 1.51 ms, eight
// lanes on the (cells, slots) copy 1.06 / 0.92 ms. No shared memory, no
// synchronisation beyond the warp's shuffles, no allocation.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BLOCK = 256;
constexpr int LANES = 8;            // lanes a query

struct Args {
  const int* cell_of;       // (slots, cells) through its strides
  long long slot_stride;    // elements between a cell's slots
  long long cell_stride;    // elements between cells
  const float* origin;      // (3,)
  const float* cell;        // ()
  const float* target;      // (N,3)
  const float* query;       // (Q,3)
  const bool* mask;         // (Q,)
  int* idx;                 // (Q,)
  float* dist;              // (Q,)
  long long nq;
  int slots, nx, ny, nz;
};

// _cell_ijk on one axis before its clamp
__device__ __forceinline__ float cell_floor(float q, float o, float c) {
  return floorf(__fdiv_rn(__fsub_rn(q, o), c));
}

// the clamp to [0, n-1] and the conversion, for f not NaN
__device__ __forceinline__ int clamp_cell(float f, int n) {
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

__device__ __forceinline__ float sq_dist(const float* t, float qx, float qy,
                                         float qz) {
  const float dx = __fsub_rn(__ldg(t), qx);
  const float dy = __fsub_rn(__ldg(t + 1), qy);
  const float dz = __fsub_rn(__ldg(t + 2), qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// torch.argmin's order on distances: a NaN beats any number
__device__ __forceinline__ bool less(float a, float b) {
  return isnan(a) ? !isnan(b) : a < b;
}

// One query by LANES lanes: lane `sub` takes slots sub, sub + LANES, ...
// of each cell, in column order, and keeps its own best (distance,
// column, point); the lanes then reduce by (distance, column).
template <int SLOTS>
__global__ void __launch_bounds__(BLOCK) grid_query(Args a) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long q = t / LANES;
  const int sub = (int)(t % LANES);
  const bool live = q < a.nq;       // every lane of the warp shuffles
  const bool on = live && a.mask[q];

  float best_d = CUDART_INF_F;
  int best_c = 0x7fffffff, best_i = -1;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f;
  if (on) {
    const float* qp = a.query + 3 * q;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
    const float c = __ldg(a.cell);
    fx = cell_floor(qx, __ldg(a.origin), c);
    fy = cell_floor(qy, __ldg(a.origin + 1), c);
    fz = cell_floor(qz, __ldg(a.origin + 2), c);
  }
  // a NaN coordinate: no candidate
  if (on && !isnan(fx) && !isnan(fy) && !isnan(fz)) {
    const int ix = clamp_cell(fx, a.nx);
    const int iy = clamp_cell(fy, a.ny);
    const int iz = clamp_cell(fz, a.nz);
    const int slots = SLOTS ? SLOTS : a.slots;
    int o = 0;
    for (int dx = -1; dx <= 1; ++dx) {
      const int cx = ix + dx;
      for (int dy = -1; dy <= 1; ++dy) {
        const int cy = iy + dy;
        for (int dz = -1; dz <= 1; ++dz, ++o) {
          const int cz = iz + dz;
          if (cx < 0 || cx >= a.nx || cy < 0 || cy >= a.ny || cz < 0 ||
              cz >= a.nz)
            continue;
          const int* cp =
              a.cell_of +
              (((long long)cx * a.ny + cy) * a.nz + cz) * a.cell_stride;
#pragma unroll
          for (int s = sub; s < slots; s += LANES) {
            const int p = __ldg(cp + s * a.slot_stride);
            if (p < 0) break;       // the filled slots are a prefix
            const float d = sq_dist(a.target + 3LL * p, qx, qy, qz);
            // column 0 is argmin's answer when nothing is less than inf
            if (less(d, best_d) || (o == 0 && s == 0)) {
              best_d = d;
              best_c = o * slots + s;
              best_i = p;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = LANES / 2; m > 0; m /= 2) {
    const float od = __shfl_xor_sync(0xffffffffu, best_d, m, LANES);
    const int oc = __shfl_xor_sync(0xffffffffu, best_c, m, LANES);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, m, LANES);
    const bool same = od == best_d || (isnan(od) && isnan(best_d));
    if (less(od, best_d) || (same && oc < best_c)) {
      best_d = od;
      best_c = oc;
      best_i = oi;
    }
  }
  if (sub != 0 || !live) return;
  const bool hit = on && best_i >= 0;
  a.idx[q] = hit ? best_i : -1;
  a.dist[q] = hit ? __fsqrt_rn(best_d) : CUDART_INF_F;
}

}  // namespace

extern "C" int repas_grid_query(const void* cell_of, long long slot_stride,
                                long long cell_stride, const void* origin,
                                const void* cell, const void* target,
                                const void* query, const void* mask,
                                void* idx, void* dist, long long nq,
                                int slots, int nx, int ny, int nz, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return 0;
  const Args a{(const int*)cell_of, slot_stride, cell_stride,
               (const float*)origin, (const float*)cell,
               (const float*)target, (const float*)query, (const bool*)mask,
               (int*)idx, (float*)dist, nq, slots, nx, ny, nz};
  const unsigned blocks = (unsigned)((nq * LANES + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (slots == 16)
    grid_query<16><<<blocks, BLOCK, 0, s>>>(a);
  else if (slots == 8)
    grid_query<8><<<blocks, BLOCK, 0, s>>>(a);
  else
    grid_query<0><<<blocks, BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}
