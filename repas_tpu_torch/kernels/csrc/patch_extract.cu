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
// x = starts[1 - yi] * x_unit, each start taken by jax.lax.dynamic_slice's
// rule: a negative start counts from the end (the dimension is added),
// then it is clamped so the window fits (B5's wrapper refuses a window
// that does not fit before the launch, or its caller has checked the
// starts, so there the rule only guards the memory).
//
// Bound on the H100: bytes. At B2's main-path shape (16 frames x 48
// windows of 208x384 bf16) it reads and writes about 123 MB each. The
// wrapper picks one of two kernels from the geometry alone
// (kernels/patch_extract.py::window_copy_path), never from the starts:
//   window_copy: one block per window. Where every x origin is on a
//     16-byte vector by construction (B2's aligned scheme and B5: x on
//     128-element tiles; the width and the row pitch on vectors too), each
//     row is copied with 16-byte vector loads and stores, neighbouring
//     threads on neighbouring addresses. Where TMA refuses the geometry
//     (a row pitch off 16 bytes, a window row off 4) it copies element by
//     element. A window whose x breaks the caller's alignment promise
//     takes that element path too, so the memory stays safe and the
//     result exact.
//   window_copy_tma: windows at arbitrary x (B6, B2's degraded exact
//     geometry as the tracker's 256-column ROI step gives it). A 2-byte
//     copy per thread per element ran B6 at 32 % of its bound; here the
//     Tensor Memory Accelerator loads whole boxes. Each window is split
//     into row bands of bh rows (and, wider than 248 bf16 or 252 f32
//     elements, column boxes of bw); a persistent grid walks the (window,
//     band, box) tasks. TMA faults on a box whose first column is off a
//     16-byte vector (measured on the H100: "illegal instruction" for any
//     x not a multiple of 8 bf16 elements), so each box is an aligned
//     cover, as the TPU kernel's DMA is: bw plus one vector of columns
//     from x rounded down, bh rows, over the pyramid viewed as (B*Hp rows,
//     W columns). In each CTA thread 0 keeps a ring of `stages` shared
//     buffers loading (the next stages - 1 boxes are in flight while one
//     is copied out); on each buffer's mbarrier all 128 threads wait for
//     the box's bytes, then copy the window's part of it out, each warp a
//     row, each lane a 32-bit word funnel-shifted by the residual (x mod
//     vector) from two shared words, stored to its place in the window
//     (rows of 128 contiguous bytes a warp). A band past the window's last
//     row still loads a whole box (rows past the pyramid's end come back
//     as TMA's zero fill) and copies out only the window's rows. The
//     window's width times the element size must be a multiple of 4.
// Every path copies raw bits (2- or 4-byte elements), so the result equals
// the plain version exactly.

#include <cuda.h>            // CUtensorMap and CUDA driver enums (types only)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// jax.lax.dynamic_slice's start rule for one dimension
__device__ __forceinline__ int slice_start(int s, int dim, int size) {
  if (s < 0) s += dim;
  return min(max(s, 0), dim - size);
}

template <typename T>
__global__ void window_copy(const T* __restrict__ pyr,
                            const int* __restrict__ starts,
                            T* __restrict__ out, int C, int Hp, int W, int ah,
                            int aw, int yi, int y_unit, int x_unit) {
  constexpr int kVec = 16 / sizeof(T);
  const int win = blockIdx.x;
  const int b = win / C;
  const int y = slice_start(starts[2 * win + yi] * y_unit, Hp, ah);
  const int x = slice_start(starts[2 * win + 1 - yi] * x_unit, W, aw);
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

// ---- TMA path ------------------------------------------------------------

constexpr int kTmaThreads = 128;

struct TmaGeom {
  int C, Hp, W, ah, aw, yi, y_unit, x_unit, elem, vec;
  int bh, bw, cols, bands, tasks, stages;
  uint32_t box_bytes, stage_bytes, box_words;  // box_words: words a row
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase of `parity` to complete. A transfer that never
// completes traps after about 2^34 cycles (seconds) rather than hang the
// card: the launch then fails with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// Thread 0 loads the boxes; all threads copy them out.
__global__ void __launch_bounds__(kTmaThreads)
    window_copy_tma(const __grid_constant__ CUtensorMap src_map,
                    const int* __restrict__ starts,
                    uint32_t* __restrict__ out, const TmaGeom g) {
  extern __shared__ unsigned char smem_raw[];
  // TMA wants its shared buffers 128-byte aligned; the launch adds slack
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t pad = ((base + 127u) & ~127u) - base;
  const uint32_t* bufs = reinterpret_cast<const uint32_t*>(smem_raw + pad);
  const uint32_t buf0 = base + pad;
  const uint32_t bar0 = buf0 + (uint32_t)g.stages * g.stage_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(bar0 + 8u * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int per_win = g.bands * g.cols;
  const int n = (g.tasks - (int)blockIdx.x + (int)gridDim.x - 1) /
                (int)gridDim.x;  // this CTA's tasks: blockIdx.x + k * grid

  // task k's window, band, column box and its window's origin
  auto task = [&](int k, int& win, int& band, int& col, int& y, int& x) {
    const int t = (int)blockIdx.x + k * (int)gridDim.x;
    win = t / per_win;
    band = (t % per_win) / g.cols;
    col = t % g.cols;
    y = slice_start(__ldg(starts + 2 * win + g.yi) * g.y_unit, g.Hp, g.ah);
    x = slice_start(__ldg(starts + 2 * win + 1 - g.yi) * g.x_unit, g.W,
                    g.aw);
  };
  // the box: bw + vec columns from x rounded down to a 16-byte vector
  // (TMA faults on a box whose first column is off one), bh rows
  auto load_box = [&](int k) {
    int win, band, col, y, x;
    task(k, win, band, col, y, x);
    const int s = k % g.stages;
    const uint32_t bar = bar0 + 8u * s;
    mbar_expect_tx(bar, g.box_bytes);
    tma_load_2d(buf0 + (uint32_t)s * g.stage_bytes, &src_map, bar,
                (x & ~(g.vec - 1)) + col * g.bw,
                (win / g.C) * g.Hp + y + band * g.bh);
  };

  if (tid == 0)
    for (int k = 0; k < min(g.stages, n); ++k) load_box(k);
  const int out_row_words = g.aw * g.elem / 4;
  for (int k = 0; k < n; ++k) {
    const int s = k % g.stages;
    int win, band, col, y, x;
    task(k, win, band, col, y, x);
    mbar_wait(bar0 + 8u * s, (uint32_t)(k / g.stages) & 1u);
    // the window's columns begin (x mod vec) elements into the box: word
    // q of a box row, shifted right by `shift` bits (0 or 16)
    const int skew = (x & (g.vec - 1)) * g.elem;
    const int q = skew >> 2, shift = (skew & 3) * 8;
    const int rows = min(g.bh, g.ah - band * g.bh);
    const int words = min(g.bw, g.aw - col * g.bw) * g.elem / 4;
    const uint32_t* box = bufs + (size_t)s * (g.stage_bytes / 4) + q;
    uint32_t* dst = out + ((size_t)win * g.ah + (size_t)band * g.bh) *
                              out_row_words + col * g.bw * g.elem / 4;
    for (int r = warp; r < rows; r += kTmaThreads / 32) {
      const uint32_t* src = box + r * g.box_words;
      uint32_t* d = dst + (size_t)r * out_row_words;
      for (int j = lane; j < words; j += 32)
        d[j] = __funnelshift_r(src[j], src[j + 1], shift);
    }
    __syncthreads();  // every thread is done with buffer s
    if (tid == 0 && k + g.stages < n) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_box(k + g.stages);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's CUDA driver entry point, so
// the library links no CUDA driver library; null if the CUDA driver lacks
// it.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// CUDA driver failures come back negative: -CUresult, or kNoEncode when
// the CUDA driver has no cuTensorMapEncodeTiled (_build.py's
// NO_DRIVER_CALL).
constexpr int kNoEncode = -100000;

int launch_tma(const void* pyr, const int* starts, void* out, int B, int C,
               int Hp, int W, int ah, int aw, int elem, int yi, int y_unit,
               int x_unit, int bh, int bw, int stages, int grid,
               cudaStream_t s) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return kNoEncode;
  TmaGeom g;
  g.C = C, g.Hp = Hp, g.W = W, g.ah = ah, g.aw = aw, g.yi = yi;
  g.y_unit = y_unit, g.x_unit = x_unit, g.elem = elem, g.vec = 16 / elem;
  g.bh = bh, g.bw = bw, g.cols = (aw + bw - 1) / bw;
  g.bands = (ah + bh - 1) / bh;
  g.tasks = B * C * g.bands * g.cols;
  g.stages = stages;
  const int box_w = bw + g.vec;
  g.box_words = (uint32_t)box_w * elem / 4;
  g.box_bytes = (uint32_t)bh * box_w * elem;
  g.stage_bytes = (g.box_bytes + 127u) & ~127u;

  CUtensorMap src_map;
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)B * Hp};
  const cuuint64_t strides[1] = {(cuuint64_t)W * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_w, (cuuint32_t)bh};
  const cuuint32_t ones[2] = {1, 1};
  CUresult r = encode(&src_map,
                      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_UINT32
                                : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                      2, const_cast<void*>(pyr), dims, strides, box, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(int)r;
  const size_t smem = 128 + (size_t)stages * g.stage_bytes + 8 * stages;
  cudaError_t err = cudaFuncSetAttribute(
      window_copy_tma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_copy_tma<<<grid, kTmaThreads, smem, s>>>(src_map, starts,
                                                  (uint32_t*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_size 2 or 4 (the wrapper refuses others); yi 0 for [y, x] starts,
// 1 for [x, y]; y_unit, x_unit: elements per start unit. path 0 runs
// window_copy, 1 window_copy_tma with row bands of bh rows, column boxes
// of bw, a ring of `stages` buffers and `grid` CTAs (the wrapper's plan,
// which meets TMA's rules: W * elem_size and bw * elem_size multiples of
// 16 bytes, bw and bh at most 256, the pyramid 16-byte aligned).
extern "C" int repas_patch_extract(const void* pyr, const void* starts,
                                   void* out, int B, int C, int Hp, int W,
                                   int ah, int aw, int elem_size, int yi,
                                   int y_unit, int x_unit, int path, int bh,
                                   int bw, int stages, int grid, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B * C == 0) return 0;
  if (elem_size != 2 && elem_size != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* st = (const int*)starts;
  if (path == 1) {
    return launch_tma(pyr, st, out, B, C, Hp, W, ah, aw, elem_size, yi,
                      y_unit, x_unit, bh, bw, stages, grid, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (elem_size == 4) {
    window_copy<uint32_t><<<B * C, 256, 0, s>>>(
        (const uint32_t*)pyr, st, (uint32_t*)out, C, Hp, W, ah, aw, yi,
        y_unit, x_unit);
  } else {
    window_copy<uint16_t><<<B * C, 256, 0, s>>>(
        (const uint16_t*)pyr, st, (uint16_t*)out, C, Hp, W, ah, aw, yi,
        y_unit, x_unit);
  }
  return (int)cudaGetLastError();
}
