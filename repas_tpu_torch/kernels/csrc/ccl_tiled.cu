// Kernel B4's unit: forward + backward segmented min-scan of a batch of
// label images along rows or along columns.
//
// Replaces the Pallas kernel repas_tpu/kernels/ccl_pallas.py::
// _make_scan_kernel (the row-band and column-band calls of
// connected_components_pallas_tiled). The unit takes (mask, labels) and
// returns, along the chosen axis, the inclusive segmented running min
// forward, then backward over that result, with background reset to the
// sentinel H*W. A background pixel starts a segment with its own input
// label (the reference's combine keeps it), and a segment that reaches the
// image edge also takes the sentinel, so the unit gives the reference's
// bits on any input labels, not only on the CCL's. The tiled CCL that the
// reference builds from this unit is, on the card, the band-resident CCL
// of ccl.cu in grid mode (one cooperative launch per group of images);
// the unit stays as the direct counterpart of the Pallas kernel.
//
// Bound on the H100: dependent memory latency. At the robust ladder's
// shapes the batch is small (2-4 images) and the images large (720x1280,
// 3.7 MB of labels each, L2-resident). One thread per column would give
// 5,120 threads at (4,720,1280), each walking 1,440 dependent loads: far
// too few threads for 132 SMs. So the column unit cuts every column into
// chunks of `chunk` rows: a chunk-local segmented scan writes each chunk's
// (running min, saw-a-break) aggregate, a carry pass walks the aggregates
// of each column, and an apply pass folds the carry into each chunk's
// prefix up to its first background pixel. Neighbouring threads take
// neighbouring columns, so every load is coalesced. The row unit is the
// warp-per-row shuffle scan of ccl.cu (a row is contiguous), which takes
// any input labels. 3 launches per direction of the column unit.

#include <cuda_runtime.h>
#include <stdint.h>

// the row pass (ccl.cu), launched on the caller's device
extern "C" int repas_ccl_rows(const void* mask, const void* src, void* dst,
                              int B, int H, int W, void* stream);

namespace {

constexpr int kColThreads = 128;

// Row of scan position p along a column, forward or backward.
__device__ __forceinline__ int col_row(int p, int H, int reverse) {
  return reverse ? H - 1 - p : p;
}

// Column unit, pass 1: thread (x, chunk c, frame b) scans scan positions
// [c*chunk, (c+1)*chunk) of column x with a running min that restarts at
// each background pixel, writes the masked local values, and the chunk's
// aggregate (running value at its end, whether it held a break).
__global__ void scan_cols_local(const uint8_t* __restrict__ mask,
                                const int* src, int* dst,
                                int* __restrict__ agg_v,
                                uint8_t* __restrict__ agg_b, int H, int W,
                                int chunk, int reverse) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int c = blockIdx.y, b = blockIdx.z;
  const int sent = H * W;
  const size_t img = (size_t)b * H * W + x;
  const int p0 = c * chunk, p1 = min(p0 + chunk, H);
  int run = sent, brk = 0;
  for (int p = p0; p < p1; ++p) {
    const size_t i = img + (size_t)col_row(p, H, reverse) * W;
    const int v = src[i];
    if (mask[i]) {
      run = min(run, v);
      dst[i] = run;
    } else {
      run = v;
      brk = 1;
      dst[i] = sent;
    }
  }
  const size_t a = ((size_t)b * gridDim.y + c) * W + x;
  agg_v[a] = run;
  agg_b[a] = (uint8_t)brk;
}

// Column unit, pass 2: thread (frame, column) turns the chunk aggregates
// into each chunk's carry-in, in place: the segmented min over all earlier
// chunks back to the last break, the sentinel before the first.
__global__ void scan_cols_carry(int* agg_v, const uint8_t* __restrict__ agg_b,
                                int B, int H, int W, int nchunk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * W) return;
  const int b = t / W, x = t % W;
  int carry = H * W;
  for (int c = 0; c < nchunk; ++c) {
    const size_t a = ((size_t)b * nchunk + c) * W + x;
    const int v = agg_v[a];
    agg_v[a] = carry;
    carry = agg_b[a] ? v : min(carry, v);
  }
}

// Column unit, pass 3: fold each chunk's carry-in into its elements up to
// the chunk's first background pixel.
__global__ void scan_cols_apply(const uint8_t* __restrict__ mask, int* dst,
                                const int* __restrict__ carry_in, int H,
                                int W, int chunk, int reverse) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int c = blockIdx.y, b = blockIdx.z;
  const int cin = carry_in[((size_t)b * gridDim.y + c) * W + x];
  const size_t img = (size_t)b * H * W + x;
  const int p0 = c * chunk, p1 = min(p0 + chunk, H);
  for (int p = p0; p < p1; ++p) {
    const size_t i = img + (size_t)col_row(p, H, reverse) * W;
    if (!mask[i]) break;
    dst[i] = min(dst[i], cin);
  }
}

cudaError_t scan_cols(const uint8_t* m, const int* src, int* dst, int* agg_v,
                      uint8_t* agg_b, int B, int H, int W, int chunk,
                      cudaStream_t s) {
  const int nchunk = (H + chunk - 1) / chunk;
  const dim3 grid((W + kColThreads - 1) / kColThreads, nchunk, B);
  const int carry_blocks = (B * W + kColThreads - 1) / kColThreads;
  cudaError_t err;
  for (int reverse = 0; reverse < 2; ++reverse) {
    scan_cols_local<<<grid, kColThreads, 0, s>>>(
        m, reverse ? dst : src, dst, agg_v, agg_b, H, W, chunk, reverse);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_cols_carry<<<carry_blocks, kColThreads, 0, s>>>(agg_v, agg_b, B, H,
                                                         W, nchunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_cols_apply<<<grid, kColThreads, 0, s>>>(m, dst, agg_v, H, W, chunk,
                                                 reverse);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The unit: labels -> out along rows (along_rows != 0) or columns.
// agg_v / agg_b hold B * ceil(H/chunk) * W entries (column unit only).
extern "C" int repas_seg_scan(const void* mask, const void* labels, void* out,
                              void* agg_v, void* agg_b, int B, int H, int W,
                              int along_rows, int chunk, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  if (along_rows) return repas_ccl_rows(mask, labels, out, B, H, W, stream);
  return (int)scan_cols(m, (const int*)labels, (int*)out, (int*)agg_v,
                        (uint8_t*)agg_b, B, H, W, chunk, s);
}
