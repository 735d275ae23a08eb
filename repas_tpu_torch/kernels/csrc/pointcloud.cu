// Fused u16 depth + packed RGB -> planar (6, H*W) colored point cloud.
//
// Replaces the Pallas kernel
// repas_tpu/kernels/pointcloud.py::_fused_pointcloud_pallas (entry
// fused_pointcloud). Per pixel (u, v) of frame b, with z = d * scale:
//   x = (u - cx) * z * (1/fx),  y = (v - cy) * z * (1/fy),  z,
//   r, g, b = byte * (1/255), zeroed where z <= 0
// in exactly the Pallas kernel's operation order, on every shape.
//
// Bound on the H100: bytes. Each point reads 6 B (2 depth + 4 packed
// colour) and writes 24 B, about 442 MB per batch of 16 720p frames, and
// does a handful of flops. Design: one thread per pixel; each of the six
// output planes is written by consecutive threads at consecutive
// addresses, so every load and store is coalesced. K is read from device
// memory (no host sync for its values).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pointcloud(const uint16_t* __restrict__ depth,
                           const int* __restrict__ rgb,
                           const float* __restrict__ K, float scale,
                           float* __restrict__ out, int B, int H, int W) {
  const size_t n = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * n) return;
  const size_t b = i / n;
  const int p = (int)(i - b * n);
  const float u = (float)(p % W);
  const float v = (float)(p / W);
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const float z = (float)depth[i] * scale;
  const float inv255 = z > 0.0f ? (float)(1.0 / 255.0) : 0.0f;
  const int c = rgb[i];
  float* o = out + b * 6 * n + p;
  o[0] = (u - cx) * z * (1.0f / fx);
  o[n] = (v - cy) * z * (1.0f / fy);
  o[2 * n] = z;
  o[3 * n] = (float)(c & 0xFF) * inv255;
  o[4 * n] = (float)((c >> 8) & 0xFF) * inv255;
  o[5 * n] = (float)((c >> 16) & 0xFF) * inv255;
}

}  // namespace

extern "C" int repas_pointcloud(const void* depth, const void* rgb,
                                const void* K, float scale, void* out, int B,
                                int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  pointcloud<<<(unsigned)((total + threads - 1) / threads), threads, 0,
               (cudaStream_t)stream>>>(
      (const uint16_t*)depth, (const int*)rgb, (const float*)K, scale,
      (float*)out, B, H, W);
  return (int)cudaGetLastError();
}
