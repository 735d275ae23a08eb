// Batched window copy out of a row-concatenated image pyramid.
//
// Replaces three Pallas kernels, all copies of windows at per-window
// starts (B, C windows of ah x aw out of a (B, Hp, W) pyramid):
//   B2 repas_tpu/kernels/patch_extract.py::_extract_dma_batched (entry
//      extract_patches_pyramid via _extract_tpu): bf16, origins [y, x]
//      in elements;
//   B5 tools/micro_perf.py::_extract_dma_batched: f32 or bf16, starts
//      [x_block, y_block] in (tile_h, 128) tile units;
//   B6 the extract_dma closure of tools/micro_perf.py::main (section
//      dmapatch2): the exact (192, 192) bf16 window at an arbitrary start
//      [x, y]. The TPU kernel DMAs an aligned cover into VMEM and rolls it
//      along the lanes; here that is a copy of the exact window.
// Window (b, c) is pyr[b, y:y+ah, x:x+aw] with y = starts[yi] * y_unit and
// x = starts[1 - yi] * x_unit, clamped so the window fits, as
// jax.lax.dynamic_slice clamps its start indices (B5's wrapper refuses a
// window that does not fit before the launch, or its caller has checked
// the starts, so there the clamp only guards the memory).
//
// Bound on the H100: bytes. At B2's main-path shape (16 frames x 48
// windows of 208x384 bf16) it reads and writes about 123 MB each. Design:
// one block per window; when the window's x origin, its width and the row
// pitch are multiples of one 16-byte vector (8 bf16 or 4 f32 elements:
// B2's and B5's aligned geometries, x origins multiples of 128) every row
// is copied with 16-byte vector loads and stores, neighbouring threads on
// neighbouring addresses; otherwise (B6, the degraded exact-window
// geometry) element by element. The copy is of raw bits, templated on the
// element size, so the result equals the plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void window_copy(const T* __restrict__ pyr,
                            const int* __restrict__ starts,
                            T* __restrict__ out, int C, int Hp, int W, int ah,
                            int aw, int yi, int y_unit, int x_unit) {
  constexpr int kVec = 16 / sizeof(T);
  const int win = blockIdx.x;
  const int b = win / C;
  const int y = min(max(starts[2 * win + yi] * y_unit, 0), Hp - ah);
  const int x = min(max(starts[2 * win + 1 - yi] * x_unit, 0), W - aw);
  const T* src = pyr + ((size_t)b * Hp + y) * W + x;
  T* dst = out + (size_t)win * ah * aw;
  if (((x | aw | W) & (kVec - 1)) == 0) {
    const int nv = aw / kVec;
    const int total = ah * nv;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / nv, c = i % nv;
      reinterpret_cast<uint4*>(dst + (size_t)r * aw)[c] =
          reinterpret_cast<const uint4*>(src + (size_t)r * W)[c];
    }
  } else {
    const int total = ah * aw;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / aw, c = i % aw;
      dst[i] = src[(size_t)r * W + c];
    }
  }
}

}  // namespace

// elem_size 2 or 4 (the wrapper refuses others); yi 0 for [y, x] starts,
// 1 for [x, y]; y_unit, x_unit: elements per start unit.
extern "C" int repas_patch_extract(const void* pyr, const void* starts,
                                   void* out, int B, int C, int Hp, int W,
                                   int ah, int aw, int elem_size, int yi,
                                   int y_unit, int x_unit, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B * C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* st = (const int*)starts;
  if (elem_size == 4) {
    window_copy<uint32_t><<<B * C, 256, 0, s>>>(
        (const uint32_t*)pyr, st, (uint32_t*)out, C, Hp, W, ah, aw, yi,
        y_unit, x_unit);
  } else if (elem_size == 2) {
    window_copy<uint16_t><<<B * C, 256, 0, s>>>(
        (const uint16_t*)pyr, st, (uint16_t*)out, C, Hp, W, ah, aw, yi,
        y_unit, x_unit);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
