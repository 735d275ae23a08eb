// Batched window copy out of a row-concatenated bf16 image pyramid.
//
// Replaces the Pallas kernel
// repas_tpu/kernels/patch_extract.py::_extract_dma_batched (entry
// extract_patches_pyramid via _extract_tpu). pyr (B,Hp,W) bf16 and
// origins (B,C,2) int32 [y, x] -> out (B,C,ah,aw) bf16, where window
// (b,c) is pyr[b, y:y+ah, x:x+aw]. Origins are clamped so the window
// fits, as jax.lax.dynamic_slice clamps its start indices.
//
// Bound on the H100: bytes. At the main path's shape (16 frames x 48
// windows of 208x384 bf16) it reads and writes about 123 MB each. Design:
// one block per window; when the window's x origin, its width and the row
// pitch are multiples of 8 elements (the aligned geometry: x origins are
// multiples of 128) every row is copied with 16-byte vector loads and
// stores, neighbouring threads on neighbouring addresses; otherwise (the
// degraded exact-window geometry) element by element. The copy is of
// raw bits, so the result equals the plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void patch_extract(const uint16_t* __restrict__ pyr,
                              const int* __restrict__ origins,
                              uint16_t* __restrict__ out, int C, int Hp,
                              int W, int ah, int aw) {
  const int win = blockIdx.x;
  const int b = win / C;
  const int y = min(max(origins[2 * win], 0), Hp - ah);
  const int x = min(max(origins[2 * win + 1], 0), W - aw);
  const uint16_t* src = pyr + ((size_t)b * Hp + y) * W + x;
  uint16_t* dst = out + (size_t)win * ah * aw;
  if (((x | aw | W) & 7) == 0) {
    const int nv = aw / 8;
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

extern "C" int repas_patch_extract(const void* pyr, const void* origins,
                                   void* out, int B, int C, int Hp, int W,
                                   int ah, int aw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B * C == 0) return 0;
  patch_extract<<<B * C, 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)pyr, (const int*)origins, (uint16_t*)out, C, Hp, W, ah,
      aw);
  return (int)cudaGetLastError();
}
