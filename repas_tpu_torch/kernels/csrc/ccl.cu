// Connected-component labels (8-connected) of a batch of masks.
//
// Replaces the Pallas kernel repas_tpu/kernels/ccl_pallas.py::_ccl_kernel
// (entry connected_components_pallas). Same fixed-iteration algorithm and
// the same labels, bit for bit: each foreground pixel starts at its linear
// index, background holds the sentinel H*W, then `iters` rounds of
//   1. forward + backward segmented running min along every row,
//   2. the same along every column,
//   3. an 8-neighbour min stencil (Jacobi: reads one buffer, writes the
//      other), background kept at the sentinel.
// Min is exact and associative, so any scan order gives the reference's
// result, including components that have not converged.
//
// Bound on the H100: memory latency and bytes, not arithmetic. The TPU
// kernel kept the whole label image in VMEM across all rounds; a 360x640
// int32 label image is 0.9 MB, far over a block's 227 KB of shared memory,
// so each pass here is its own launch over device memory. A batch of 16
// such label images is about 15 MB and stays in the 50 MB L2 between
// launches. Design: the row pass runs one warp per (frame, row) with a
// 32-wide shuffle segmented scan per chunk and a carried running min
// (coalesced loads along the row; kernel B4 launches the same pass); the
// column pass runs one thread per (frame, column), so neighbouring threads
// read neighbouring addresses; the stencil runs one thread per pixel.
// 3*iters launches per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One 32-wide chunk of a segmented inclusive min-scan: lane i holds
// (v, brk) and ends with the min back to the last break at or before it,
// or, with no break in the chunk up to it, also over `carry`.
__device__ __forceinline__ int seg_scan_chunk(int v, int brk, int carry,
                                              int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int vs = __shfl_up_sync(kFull, v, d);
    int bs = __shfl_up_sync(kFull, brk, d);
    if (lane >= d) {
      if (!brk) v = min(v, vs);
      brk |= bs;
    }
  }
  if (!brk) v = min(v, carry);
  return v;
}

// Row pass, B1's and B4's row unit (ccl_tiled.cu): one warp per (frame,
// row), forward then backward segmented running min, background reset to
// the sentinel. src == nullptr starts from the initial labels (linear
// index on the mask, sentinel elsewhere). Otherwise any labels are read,
// and a background pixel starts its segment with its own input label, as
// the reference's scan combine does (in the CCL that label is always the
// sentinel). src may alias dst.
__global__ void ccl_rows(const uint8_t* __restrict__ mask, const int* src,
                         int* dst, int B, int H, int W) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B * H) return;  // uniform across the warp
  const int sent = H * W;
  const int y = warp % H;
  const size_t base = (size_t)warp * W;
  const uint8_t* m = mask + base;
  const int* in = src ? src + base : nullptr;
  int* out = dst + base;

  int carry = sent;
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const bool ok = x < W;
    const bool fg = ok && m[x];
    int v = sent;
    if (ok) v = in ? in[x] : (fg ? y * W + x : sent);
    v = seg_scan_chunk(v, fg ? 0 : 1, carry, lane);
    // the carry is the running value before the background reset: a
    // background lane 31 starts the next chunk's segment with its label
    carry = __shfl_sync(kFull, v, 31);
    if (ok) out[x] = fg ? v : sent;
  }
  __syncwarp();  // the backward pass reads what other lanes wrote
  carry = sent;
  for (int x0 = W - 1; x0 >= 0; x0 -= 32) {
    const int x = x0 - lane;
    const bool ok = x >= 0;
    const bool fg = ok && m[x];
    int v = ok ? out[x] : sent;
    v = seg_scan_chunk(v, fg ? 0 : 1, carry, lane);
    carry = __shfl_sync(kFull, v, 31);
    if (ok) out[x] = fg ? v : sent;
  }
}

int row_blocks(int B, int H, int threads) {
  return (int)(((long long)B * H * 32 + threads - 1) / threads);
}

// Column pass, in place: one thread per (frame, column).
__global__ void ccl_cols(const uint8_t* __restrict__ mask, int* lab, int B,
                         int H, int W) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * W) return;
  const int sent = H * W;
  const size_t base = (size_t)(t / W) * H * W + (t % W);
  int run = sent;
  for (int y = 0; y < H; ++y) {
    const size_t i = base + (size_t)y * W;
    if (mask[i]) {
      run = min(run, lab[i]);
      lab[i] = run;
    } else {
      run = sent;
    }
  }
  run = sent;
  for (int y = H - 1; y >= 0; --y) {
    const size_t i = base + (size_t)y * W;
    if (mask[i]) {
      run = min(run, lab[i]);
      lab[i] = run;
    } else {
      run = sent;
    }
  }
}

// 8-neighbour min stencil, src -> dst (never in place).
__global__ void ccl_stencil(const uint8_t* __restrict__ mask,
                            const int* __restrict__ src,
                            int* __restrict__ dst, int B, int H, int W) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)H * W;
  if (i >= (size_t)B * n) return;
  const int sent = H * W;
  if (!mask[i]) {
    dst[i] = sent;
    return;
  }
  const int p = (int)(i % n);
  const int y = p / W, x = p % W;
  const int* img = src + (i - p);
  int m = src[i];
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      m = min(m, img[yy * W + xx]);
    }
  }
  dst[i] = m;
}

}  // namespace

extern "C" int repas_ccl(const void* mask, void* out, void* scratch, int B,
                         int H, int W, int iters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  // the last stencil must land in `out`: start in whichever buffer makes
  // the ping-pong end there
  int* cur = (iters % 2 == 0) ? (int*)out : (int*)scratch;
  int* other = (cur == (int*)out) ? (int*)scratch : (int*)out;
  const int threads = 256;
  const int rblocks = row_blocks(B, H, threads);
  const int col_blocks = (B * W + threads - 1) / threads;
  const long long npix = (long long)B * H * W;
  const int pix_blocks = (int)((npix + threads - 1) / threads);
  for (int it = 0; it < iters; ++it) {
    ccl_rows<<<rblocks, threads, 0, s>>>(m, it == 0 ? nullptr : cur, cur,
                                            B, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ccl_cols<<<col_blocks, threads, 0, s>>>(m, cur, B, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ccl_stencil<<<pix_blocks, threads, 0, s>>>(m, cur, other, B, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    int* t = cur;
    cur = other;
    other = t;
  }
  return (int)cudaGetLastError();
}

// The row pass alone, on the current device: B4's row unit and the first
// step of each tiled CCL round (ccl_tiled.cu).
extern "C" int repas_ccl_rows(const void* mask, const void* src, void* dst,
                              int B, int H, int W, void* stream) {
  const int threads = 256;
  ccl_rows<<<row_blocks(B, H, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int*)src, (int*)dst, B, H, W);
  return (int)cudaGetLastError();
}

// The stencil alone, on the current device: one round's last step of the
// tiled CCL (ccl_tiled.cu).
extern "C" int repas_ccl_stencil(const void* mask, const void* src, void* dst,
                                 int B, int H, int W, void* stream) {
  const int threads = 256;
  const long long npix = (long long)B * H * W;
  const int blocks = (int)((npix + threads - 1) / threads);
  ccl_stencil<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int*)src, (int*)dst, B, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* repas_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
