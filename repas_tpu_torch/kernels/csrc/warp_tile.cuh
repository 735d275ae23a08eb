// The staged I/O of kernels K1 and K2 (csrc/eig3.cu, csrc/kabsch3.cu):
// a warp's tile of consecutive matrices is one contiguous run of floats,
// copied between device memory and the warp's shared memory.
#pragma once

#include <cstdint>

// `count` floats from src to dst by the warp's lanes, one of them shared
// memory: 16-byte vectors where both are 16-byte aligned, then one by
// one.
__device__ __forceinline__ void warp_copy(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int count, int lane) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
       & 15) == 0) {
    for (int i = lane; i < count >> 2; i += 32)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    done = count & ~3;
  }
  for (int i = done + lane; i < count; i += 32) dst[i] = src[i];
}
