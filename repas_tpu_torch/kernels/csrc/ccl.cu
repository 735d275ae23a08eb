// Connected-component labels (8-connected) of a batch of masks: kernels B1
// and B4's CCL, one band-resident kernel with two synchronisation scopes.
//
// Replaces the Pallas kernel repas_tpu/kernels/ccl_pallas.py::_ccl_kernel
// (entry connected_components_pallas) and the CCL that
// connected_components_pallas_tiled builds from _make_scan_kernel. Same
// fixed-round Jacobi algorithm and the same labels, bit for bit: each
// foreground pixel starts at its linear index, background holds the
// sentinel H*W, then `iters` rounds of
//   1. forward + backward segmented running min along every row,
//   2. the same along every column,
//   3. the 8-neighbour min stencil, background kept at the sentinel.
// Min is exact and associative, so any decomposition of the scans gives
// the reference's labels, including components that have not converged.
// With `converge`, `iters` is the least number of rounds: from then on the
// bands agree after each round whether it changed any label and stop after
// the first that changed none, so every 8-connected component ends with
// one label, its least linear index (a tag's border ring turned in plane
// is a staircase that a round walks only about one border width along).
// A round changed nothing where the vertical stencil's minima repeat those
// of the round before (labels only fall, so each thread compares the sum
// of its columns' minima); then the labels before it were a fixed point.
// That costs one more synchronisation a round past `iters`, and the stop
// comes two rounds after the labels first converge. Every call adds the
// rounds each image ran, the images and one call to a device counter
// (g_counts, read by repas_ccl_counts), inside replayed graphs too.
//
// Bound on the H100: operations, 13 int32 min/select per pixel per round
// (0.24 G at (16,360,640), 14 us at the int32 rate), over the bytes (the
// mask read once and the labels written once, 18.4 MB, 5.5 us). The TPU
// kernel kept the label image in VMEM across all rounds and touched HBM
// twice; this kernel does the same in shared memory. Each CTA owns a band
// of `band_rows` whole rows of one image and holds its int32 labels in
// dynamic shared memory from the one read of the mask to the one write of
// the labels (no mask is kept: a pixel is background where its label is
// the sentinel). A band row is stored at a pitch of 32 odd-length lane
// segments, padded with background, so no access conflicts on a bank and
// no loop checks a bound. Per round:
//   rows     one warp per row of the band: each lane scans its segment
//            serially, in registers where its length has a compiled
//            variant (widths 256, 640, 1280 and those padded alike), one
//            shuffle scan per direction gives the lanes' carries (rows
//            are whole in every band); from the second round on the row
//            first takes the horizontal half of the last round's stencil;
//   columns  one thread per column: a forward running min down the band,
//            publishing the column's top-run and bottom-run minima; after
//            a synchronisation every foreground pixel takes its run's min
//            walking up, with the carries folded from the other bands'
//            aggregates back to the nearest break where the run reaches
//            the band's edge (the reference's forward-then-backward scan);
//   stencil  separable (the 3x3 min is the min of column 3-mins) and in
//            place: the band's edge rows are published with the column
//            pass, and after a synchronisation a vertical 3-min per column
//            marks background; the horizontal 3-min opens the next row
//            pass (after the last round, a pass of its own).
// Two synchronisations per round (three past `iters` with `converge`), in
// one of two scopes:
//   cluster  one thread-block cluster of 1 to 16 CTAs per image:
//            aggregates, edge rows and change flags live in shared memory
//            and are read through distributed shared memory; one launch
//            per call; each image stops converging on its own;
//   grid     one cooperative launch over the bands of a group of images,
//            every CTA resident; aggregates and edge rows go through a
//            small global buffer (L2), read past L1, the change flags
//            through atomics at its end; one launch per group, whose
//            images stop converging together.
// The launch plan (band rows, cluster size, images per launch) is made by
// the Python wrapper (kernels/ccl_cuda.py::plan_bands). A launch the card
// refuses returns its error; there is no fallback. Measured, the kernel
// runs at about a tenth of its bound: it is bound by instruction
// throughput and shared-memory traffic, the row pass the largest part.
//
// Also here: the row pass of kernel B4's unit (ccl_tiled.cu), a warp per
// (frame, row) over device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 640;   // threads of a band CTA
// published int arrays of W per band: the column aggregates carried down
// and up (value, with the sign bit set if the band's column held a break),
// the column's first background row (read by its own band), the top and
// the bottom edge row
enum { kDown, kUp, kFirstBg, kTop, kBot, kAux };
// band aggregates a carry fold loads at once
constexpr int kFoldBatch = 8;
// ints after the published arrays: two change flags, used by alternate
// rounds, padded to 16 bytes
constexpr int kFlagInts = 4;

// The device counter, per kernel (row 0 B1's calls, row 1 B4's): the
// rounds its images ran, summed, its images, its calls.
__device__ unsigned long long g_counts[2][3];

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

// Forward then backward segmented running min of one row of W labels `L`
// with mask `M`, by one warp, background reset to the sentinel. `src` is
// read in the forward pass (may alias L); a background pixel starts its
// segment with its own input label (the reference's scan combine; in the
// CCL that label is always the sentinel).
__device__ __forceinline__ void row_scan(const uint8_t* M, const int* src,
                                         int* L, int W, int sent, int lane) {
  int carry = sent;
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const bool ok = x < W;
    const bool fg = ok && M[x];
    int v = ok ? src[x] : sent;
    v = seg_scan_chunk(v, fg ? 0 : 1, carry, lane);
    // the carry is the running value before the background reset: a
    // background lane 31 starts the next chunk's segment with its label
    carry = __shfl_sync(kFull, v, 31);
    if (ok) L[x] = fg ? v : sent;
  }
  __syncwarp();  // the backward pass reads what other lanes wrote
  carry = sent;
  for (int x0 = W - 1; x0 >= 0; x0 -= 32) {
    const int x = x0 - lane;
    const bool ok = x >= 0;
    const bool fg = ok && M[x];
    int v = ok ? L[x] : sent;
    v = seg_scan_chunk(v, fg ? 0 : 1, carry, lane);
    carry = __shfl_sync(kFull, v, 31);
    if (ok) L[x] = fg ? v : sent;
  }
}

// In the band kernel a pixel is background exactly where its label is the
// sentinel: foreground labels start below it and only take minima of
// foreground labels. So the band keeps no mask. Between the two halves of
// the stencil a background pixel's column minimum is marked by setting its
// sign bit (labels fit 31 bits); kLabel masks the mark off. The padding
// past W keeps the unmarked sentinel, so a value is background where it is
// at least the sentinel as an unsigned number.
constexpr unsigned kBgBit = 0x80000000u;
constexpr int kLabel = 0x7fffffff;

__device__ __forceinline__ bool is_bg(int v, int sent) {
  return (unsigned)v >= (unsigned)sent;
}

// A band row is cut into 32 lane segments of s labels, s odd, and stored
// with a pitch of 32 * s: lane l's k-th element sits in bank (l*s + k) mod
// 32, a different bank for every lane, and no lane needs a bound check.
// The padding past W holds background.
__host__ __device__ __forceinline__ int seg_len(int W) {
  return ((W + 31) / 32) | 1;
}

// A scan aggregate (running value, whether a break was seen) packed as
// value | break << 31; the sentinel alone is the identity.
__device__ __forceinline__ unsigned agg_pack(int v, int brk) {
  return (unsigned)v | (brk ? kBgBit : 0u);
}

// Aggregate a followed by b in scan order.
__device__ __forceinline__ unsigned agg_comb(unsigned a, unsigned b) {
  return (b & kBgBit) ? b : (min(a & ~kBgBit, b) | (a & kBgBit));
}

// Carry-in of each lane's segment from the (value, break) aggregates of
// all 32: the min over the segments before it in scan order (after it if
// kDown) back to the nearest one with a break, the sentinel if none.
template <bool kDown>
__device__ __forceinline__ int lane_carry(int v, int brk, int sent,
                                          int lane) {
  unsigned k = agg_pack(v, brk);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned ks = kDown ? __shfl_down_sync(kFull, k, d)
                              : __shfl_up_sync(kFull, k, d);
    const bool in = kDown ? lane + d < 32 : lane >= d;
    k = in ? agg_comb(ks, k) : k;
  }
  const unsigned ex = kDown ? __shfl_down_sync(kFull, k, 1)
                            : __shfl_up_sync(kFull, k, 1);
  return (kDown ? lane == 31 : lane == 0) ? sent : (int)(ex & ~kBgBit);
}

// The horizontal half of the stencil at one pixel from the marked column
// minima of it and its two row neighbours: the sentinel on background.
__device__ __forceinline__ int row_min3(int left, int v, int right,
                                        int sent) {
  return is_bg(v, sent) ? sent
                        : min(v, min(left & kLabel, right & kLabel));
}

// Forward then backward segmented running min of one band row (pitch
// 32 * s), by one warp; with kStencil the row first takes the horizontal
// half of the previous round's stencil (its values are marked column
// minima). Each lane scans its segment serially, the lanes' carries come
// from one shuffle scan per direction. Three passes over the segment: its
// forward aggregate; the forward values with their carry, and the
// backward aggregate (the min of the forward values before the segment's
// first break); the backward values. Background ends at the sentinel.
template <bool kStencil>
__device__ __forceinline__ void band_row_scan(int* L, int s, int sent,
                                              int lane) {
  int* p = L + lane * s;
  // the segment's outer neighbours, read before any lane writes
  const int left = kStencil && lane ? p[-1] : sent;
  const int right = kStencil && lane < 31 ? p[s] : sent;
  // element k's input from its old value and its neighbours' (the last
  // element's right neighbour comes after the loop, no read is
  // conditional)
  auto input = [&](int prev, int cur, int nxt) {
    return kStencil ? row_min3(prev, cur, nxt, sent) : cur;
  };
  int run = sent, brk = 0;
  auto fwd_agg = [&](int v) {
    run = v < sent ? min(run, v) : sent;
    brk |= v >= sent;
  };
  int prev = left, cur = p[0];
  for (int k = 0; k + 1 < s; ++k) {
    const int nxt = p[k + 1];
    fwd_agg(input(prev, cur, nxt));
    prev = cur;
    cur = nxt;
  }
  fwd_agg(input(prev, cur, right));
  run = lane_carry<false>(run, brk, sent, lane);
  __syncwarp();
  int pre = sent, open = 1;
  brk = 0;
  auto fwd = [&](int k, int v) {
    const int fg = v < sent;
    run = fg ? min(run, v) : sent;
    p[k] = run;
    open &= fg;
    pre = open ? run : pre;
    brk |= !fg;
  };
  prev = left;
  cur = p[0];
  for (int k = 0; k + 1 < s; ++k) {
    const int nxt = p[k + 1];
    fwd(k, input(prev, cur, nxt));
    prev = cur;
    cur = nxt;
  }
  fwd(s - 1, input(prev, cur, right));
  run = lane_carry<true>(pre, brk, sent, lane);
#pragma unroll 4
  for (int k = s - 1; k >= 0; --k) {
    const int v = p[k];
    run = v < sent ? min(run, v) : sent;
    p[k] = run;
  }
}

// The same row pass with the lane's segment in registers, for a segment
// length kSeg fixed at compile time: one read and one write of the segment
// in shared memory, the stencil and the three passes on registers.
template <bool kStencil, int kSeg>
__device__ __forceinline__ void band_row_scan_reg(int* L, int sent,
                                                  int lane) {
  int* p = L + lane * kSeg;
  const int left = kStencil && lane ? p[-1] : sent;
  const int right = kStencil && lane < 31 ? p[kSeg] : sent;
  int u[kSeg];
#pragma unroll
  for (int k = 0; k < kSeg; ++k) u[k] = p[k];
  if (kStencil) {
    int prev = left;
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      const int cur = u[k];
      u[k] = row_min3(prev, cur, k + 1 < kSeg ? u[k + 1] : right, sent);
      prev = cur;
    }
  }
  int run = sent, brk = 0;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    run = u[k] < sent ? min(run, u[k]) : sent;
    brk |= u[k] >= sent;
  }
  run = lane_carry<false>(run, brk, sent, lane);
  int pre = sent, open = 1;
  brk = 0;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int fg = u[k] < sent;
    run = fg ? min(run, u[k]) : sent;
    u[k] = run;
    open &= fg;
    pre = open ? run : pre;
    brk |= !fg;
  }
  run = lane_carry<true>(pre, brk, sent, lane);
#pragma unroll
  for (int k = kSeg - 1; k >= 0; --k) {
    run = u[k] < sent ? min(run, u[k]) : sent;
    u[k] = run;
  }
  __syncwarp();  // the neighbours' outer reads come before these writes
#pragma unroll
  for (int k = 0; k < kSeg; ++k) p[k] = u[k];
}

// One band row's pass, from registers where the segment length has a
// compiled variant (kSeg > 0), else from shared memory.
template <bool kStencil, int kSeg>
__device__ __forceinline__ void row_pass(int* L, int s, int sent, int lane) {
  if constexpr (kSeg > 0)
    band_row_scan_reg<kStencil, kSeg>(L, sent, lane);
  else
    band_row_scan<kStencil>(L, s, sent, lane);
}

// The horizontal half of the last round's stencil on one band row in
// place, by one warp: each lane reads its segment's outer neighbours
// first, then walks its segment with the previous element's old value in a
// register.
__device__ __forceinline__ void band_row_min3(int* L, int s, int sent,
                                              int lane) {
  int* p = L + lane * s;
  int prev = lane ? p[-1] : sent;
  const int right = lane < 31 ? p[s] : sent;
  __syncwarp();
  int cur = p[0];
  for (int k = 0; k + 1 < s; ++k) {
    const int nxt = p[k + 1];
    p[k] = row_min3(prev, cur, nxt, sent);
    prev = cur;
    cur = nxt;
  }
  p[s - 1] = row_min3(prev, cur, right, sent);
}

// Where a band publishes its aggregates and edge rows, and how the bands
// of one image synchronise.
struct ClusterScope {
  static constexpr bool kCluster = true;
  int* aux;   // this CTA's kAux * W ints of shared memory, then its flags
  int W;
  __device__ int* mine(int, int slot) const { return aux + slot * W; }
  // change flag `p` of this band (one thread), and whether any band of
  // the image set theirs (after a sync)
  __device__ void put_flag(int p, int v) const { aux[kAux * W + p] = v; }
  __device__ bool any_flag(int p, int nb) const {
    int any = 0;
    for (int j = 0; j < nb; ++j)
      any |= *cg::this_cluster().map_shared_rank(aux + kAux * W + p, j);
    return any != 0;
  }
  __device__ void clear_flag(int) const {}
  __device__ const int* theirs(int band, int slot) const {
    return cg::this_cluster().map_shared_rank(aux + slot * W, band);
  }
  __device__ int load(const int* p) const { return *p; }
  __device__ void store(int* p, int v) const { *p = v; }
  // release and acquire at cluster scope: what a band wrote to its shared
  // memory before the barrier is what the others read after it
  __device__ void sync() const {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
};

struct GridScope {
  static constexpr bool kCluster = false;
  int* aux;     // this image's nb * kAux * W ints of device memory
  int* flags;   // the launch's two change flags, after every image's aux
  int W;
  __device__ int* mine(int band, int slot) const {
    return aux + ((size_t)band * kAux + slot) * W;
  }
  // flag `p` is the launch's: a band that changed a label sets it, and
  // the launch's first thread clears it a round before its next use
  __device__ void put_flag(int p, int v) const {
    if (v) atomicOr(flags + p, 1);
  }
  __device__ bool any_flag(int p, int) const { return __ldcg(flags + p); }
  __device__ void clear_flag(int p) const {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
      __stcg(flags + p, 0);
  }
  __device__ const int* theirs(int band, int slot) const {
    return mine(band, slot);
  }
  // past L1: the same addresses take new values every round
  __device__ int load(const int* p) const { return __ldcg(p); }
  __device__ void store(int* p, int v) const { __stcg(p, v); }
  __device__ void sync() const { cg::this_grid().sync(); }
};

// Shared memory of a band CTA: its labels at the padded pitch, then the
// published arrays and the change flags in cluster scope, rounded up to 16
// bytes. The wrapper's plan mirrors this (ccl_cuda.py::band_smem).
size_t band_smem(int band_rows, int W, bool cluster) {
  const size_t ints = (size_t)band_rows * 32 * seg_len(W) +
                      (cluster ? (size_t)kAux * W + kFlagInts : 0);
  return (4 * ints + 15) / 16 * 16;
}

// Column scans, first half: the forward running min of column x (pitch P)
// down the band, restarting at background, in place. Publishes the
// column's aggregates: the min of its bottom run (below its last
// background pixel) for the bands below, the min of its top run (above
// its first background pixel) for the bands above, each marked if the
// column held background; and, for the second half, its first background
// row.
template <class Scope>
__device__ __forceinline__ void col_down(const Scope& sc, int* lab, int band,
                                         int x, int rows, int P, int sent) {
  int* p = lab + x;
  int run = sent, top = sent, open = 1, first_bg = rows;
#pragma unroll 4
  for (int r = 0; r < rows; ++r, p += P) {
    const int v = *p;
    const int fg = v < sent;
    run = fg ? min(run, v) : sent;
    *p = run;
    first_bg = open && !fg ? r : first_bg;
    open &= fg;
    top = open ? run : top;
  }
  const int brk = first_bg < rows;
  sc.store(sc.mine(band, kDown) + x, (int)agg_pack(run, brk));
  sc.store(sc.mine(band, kUp) + x, (int)agg_pack(top, brk));
  sc.store(sc.mine(band, kFirstBg) + x, first_bg);
}

// Carry of column x into this band from the aggregates in `slot` of the
// bands before it in scan order (above it, or below it if kBelow), folded
// back to the nearest one with a break; kFoldBatch loaded at once.
template <bool kBelow, class Scope>
__device__ __forceinline__ int fold(const Scope& sc, int band, int nb,
                                    int slot, int x, int sent) {
  constexpr int dir = kBelow ? 1 : -1;
  int carry = sent;
  for (int j0 = band + dir; j0 >= 0 && j0 < nb; j0 += kFoldBatch * dir) {
    int a[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      const int j = j0 + k * dir;
      a[k] = j >= 0 && j < nb ? sc.load(sc.theirs(j, slot) + x) : sent;
    }
    bool stop = false;
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      carry = stop ? carry : min(carry, a[k] & kLabel);
      stop |= a[k] < 0;
    }
    if (stop) break;
  }
  return carry;
}

// Column scans, second half: every foreground pixel of column x takes the
// min of its run, walking up the band: the forward running min at the
// run's bottom, with the carry from the bands below if the run reaches
// the band's bottom and the carry from the bands above if it reaches the
// band's top. This is the forward-then-backward scan of the reference.
// Publishes the band's edge rows for the stencil.
template <class Scope>
__device__ __forceinline__ void col_up(const Scope& sc, int* lab, int band,
                                       int nb, int x, int rows, int P,
                                       int sent) {
  const int above = fold<false>(sc, band, nb, kDown, x, sent);
  int run = fold<true>(sc, band, nb, kUp, x, sent);
  const int first_bg = sc.load(sc.mine(band, kFirstBg) + x);
  int* p = lab + (rows - 1) * P + x;
  int bottom = sent;
#pragma unroll 4
  for (int r = rows - 1; r >= 0; --r, p -= P) {
    const int v = *p;
    run = v < sent ? min(run, v) : sent;
    const int out = r < first_bg ? min(run, above) : run;
    *p = out;
    bottom = r == rows - 1 ? out : bottom;
  }
  sc.store(sc.mine(band, kTop) + x, rows ? lab[x] : sent);
  sc.store(sc.mine(band, kBot) + x, bottom);
}

// The vertical half of the stencil on column x (pitch P) in place: the
// min of each pixel and its two column neighbours (the neighbouring
// bands' edge rows at the band's ends), marked on background; the
// previous row's old value rides in a register. With kSum, returns the
// sum of the foreground pixels' minima.
template <bool kSum>
__device__ __forceinline__ long long col_min3(int* lab, int x, int rows,
                                              int P, int sent, int above,
                                              int below) {
  long long sum = 0;
  if (!rows) return sum;
  auto put = [&](int i, int prev, int cur, int nxt) {
    const int m = min(prev, min(cur, nxt));
    lab[i] = cur == sent ? (int)((unsigned)m | kBgBit) : m;
    if (kSum) sum += cur == sent ? 0 : m;
  };
  int prev = above, cur = lab[x];
  for (int r = 0; r + 1 < rows; ++r) {
    const int nxt = lab[(r + 1) * P + x];
    put(r * P + x, prev, cur, nxt);
    prev = cur;
    cur = nxt;
  }
  put((rows - 1) * P + x, prev, cur, below);
  return sum;
}

// One band of one image: blockIdx.x is the band, blockIdx.y the image of
// this launch. Bands past the image's last row hold no rows; they publish
// the scans' identity and sentinel edges. kSeg > 0 is the row segment
// length of a register-resident row pass (W's seg_len), 0 for any W.
// kConverge: rounds past `iters` until one changes nothing. The rounds
// are counted in row `counter` of g_counts, the call where count_call.
template <class Scope, int kSeg, bool kConverge>
__global__ void __launch_bounds__(kThreads, kSeg > 21 ? 1 : 2)
    ccl_band(const uint8_t* __restrict__ mask, int* __restrict__ out,
             int* __restrict__ gaux, int H, int W, int iters, int band_rows,
             int counter, int count_call) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int band = blockIdx.x, nb = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;
  const int sent = H * W;
  const int s = kSeg ? kSeg : seg_len(W), P = 32 * s;
  const int y0 = band * band_rows;
  const int rows = max(0, min(band_rows, H - y0));
  int* lab = reinterpret_cast<int*>(smem);
  Scope sc;
  if constexpr (Scope::kCluster) {
    sc = Scope{lab + (size_t)band_rows * P, W};
  } else {
    sc = Scope{gaux + (size_t)blockIdx.y * nb * kAux * W,
               gaux + (size_t)gridDim.y * nb * kAux * W, W};
  }

  // the band's mask, read once, as initial labels; background padding
  const size_t img = (size_t)blockIdx.y * H * W + (size_t)y0 * W;
  for (int r = 0; r < rows; ++r)
    for (int x = tid; x < P; x += kThreads)
      lab[r * P + x] =
          x < W && mask[img + r * W + x] ? (y0 + r) * W + x : sent;
  __syncthreads();

  // with kConverge, the sum of this thread's columns' vertical minima in
  // the last round (none before the first)
  long long last_sum = -1;
  int it = 0;   // rounds done
  for (;;) {
    // 1. rows, after the horizontal half of the last round's stencil
    for (int r = warp; r < rows; r += nwarps) {
      if (it)
        row_pass<true, kSeg>(lab + r * P, s, sent, lane);
      else
        row_pass<false, kSeg>(lab + r * P, s, sent, lane);
    }
    __syncthreads();

    // 2. columns: forward running min down, aggregates published; then
    // the runs' minima up, with the carries from the other bands
    for (int x = tid; x < W; x += kThreads)
      col_down(sc, lab, band, x, rows, P, sent);
    sc.sync();
    // every band has read the flag of two rounds back: it may be reused
    if constexpr (kConverge) sc.clear_flag((it + 1) & 1);
    for (int x = tid; x < W; x += kThreads)
      col_up(sc, lab, band, nb, x, rows, P, sent);
    sc.sync();

    // 3. stencil, vertical half; the horizontal half opens the next
    // round's row pass
    long long sum = 0;
    for (int x = tid; x < W; x += kThreads)
      sum += col_min3<kConverge>(
          lab, x, rows, P, sent,
          band > 0 ? sc.load(sc.theirs(band - 1, kBot) + x) : sent,
          band + 1 < nb ? sc.load(sc.theirs(band + 1, kTop) + x) : sent);
    ++it;
    if constexpr (kConverge) {
      const int changed = __syncthreads_or(sum != last_sum);
      last_sum = sum;
      if (it < max(iters, 2)) continue;
      if (tid == 0) sc.put_flag(it & 1, changed);
      sc.sync();
      if (!sc.any_flag(it & 1, nb)) break;
    } else {
      __syncthreads();
      if (it == iters) break;
    }
  }
  for (int r = warp; r < rows; r += nwarps)
    band_row_min3(lab + r * P, s, sent, lane);
  // in cluster scope no CTA may leave while another can still read its
  // shared memory (the last round's edge rows)
  if constexpr (Scope::kCluster) sc.sync();
  else __syncthreads();

  // the labels, written once
  for (int r = 0; r < rows; ++r)
    for (int x = tid; x < W; x += kThreads)
      out[img + r * W + x] = lab[r * P + x];
  if (band == 0 && tid == 0) {
    atomicAdd(&g_counts[counter][0], (unsigned long long)it);
    atomicAdd(&g_counts[counter][1], 1ull);
    if (count_call && blockIdx.y == 0) atomicAdd(&g_counts[counter][2], 1ull);
  }
}

// Row pass over device memory, B4's row unit: one warp per (frame, row),
// any input labels. src may alias dst.
__global__ void ccl_rows(const uint8_t* __restrict__ mask, const int* src,
                         int* dst, int B, int H, int W) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B * H) return;  // uniform across the warp
  const size_t base = (size_t)warp * W;
  row_scan(mask + base, src + base, dst + base, W, H * W, lane);
}

// Calls f with std::integral_constant<int, kSeg>: the compiled
// register-resident row pass for W's segment length (W = 256, 640, 1280
// and the widths that pad to the same pitch), else 0.
template <class F>
cudaError_t with_seg(int W, F&& f) {
  switch (seg_len(W)) {
    case 9: return f(std::integral_constant<int, 9>());
    case 21: return f(std::integral_constant<int, 21>());
    case 41: return f(std::integral_constant<int, 41>());
    default: return f(std::integral_constant<int, 0>());
  }
}

// Opts kernel `kern` into `smem` bytes of dynamic shared memory and, for a
// cluster over 8 CTAs, into non-portable cluster sizes.
template <class K>
cudaError_t prepare(K kern, size_t smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Launch configuration of one cluster of `cluster` band CTAs per image.
struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterConfig(int cluster, int B, size_t smem, cudaStream_t s) {
    cfg.gridDim = dim3(cluster, B, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Calls f with std::integral_constant<bool, converge>.
template <class F>
cudaError_t with_converge(int converge, F&& f) {
  return converge ? f(std::true_type()) : f(std::false_type());
}

}  // namespace

// The band-resident CCL: mask (B,H,W) uint8 -> out (B,H,W) int32, `iters`
// rounds, or with `converge` at least `iters` and on to the fixed point,
// counted in row `counter` (0 B1, 1 B4) of the device counter. With
// cluster > 0, one cluster of `cluster` bands per image, one launch; with
// cluster == 0, cooperative launches over `group` images at a time, bands
// of `band_rows` rows, `aux` holding group * ceil(H/band_rows) * kAux * W
// + kFlagInts ints. Returns the first launch's error, if any.
extern "C" int repas_ccl(const void* mask, void* out, void* aux, int B, int H,
                         int W, int iters, int converge, int counter,
                         int cluster, int band_rows, int group, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (band_rows < 1 || iters < 1 || (cluster == 0 && group < 1) ||
      counter < 0 || counter > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  int* o = (int*)out;
  const size_t smem = band_smem(band_rows, W, cluster > 0);
  return (int)with_seg(W, [&](auto seg) {
    return with_converge(converge, [&](auto conv) {
      constexpr int kSeg = decltype(seg)::value;
      constexpr bool kConv = decltype(conv)::value;
      cudaError_t e;
      if (cluster > 0) {
        auto kern = ccl_band<ClusterScope, kSeg, kConv>;
        if ((e = prepare(kern, smem, cluster)) != cudaSuccess) return e;
        ClusterConfig cc(cluster, B, smem, s);
        int* no_aux = nullptr;
        if ((e = cudaLaunchKernelEx(&cc.cfg, kern, m, o, no_aux, H, W, iters,
                                    band_rows, counter, 1)) != cudaSuccess)
          return e;
        return cudaGetLastError();
      }
      auto kern = ccl_band<GridScope, kSeg, kConv>;
      if ((e = prepare(kern, smem, 0)) != cudaSuccess) return e;
      const int nb = (H + band_rows - 1) / band_rows;
      for (int b0 = 0; b0 < B; b0 += group) {
        const int g = min(group, B - b0);
        const uint8_t* mg = m + (size_t)b0 * H * W;
        int* og = o + (size_t)b0 * H * W;
        int* ag = (int*)aux;
        int first = b0 == 0;
        void* args[] = {&mg, &og, &ag, &H, &W, &iters, &band_rows,
                        &counter, &first};
        if ((e = cudaLaunchCooperativeKernel((const void*)kern,
                                             dim3(nb, g, 1),
                                             dim3(kThreads, 1, 1), args,
                                             smem, s)) != cudaSuccess)
          return e;
      }
      return cudaGetLastError();
    });
  });
}

// The device counter (g_counts) into out[6]: B1's rounds, images and
// calls, then B4's, since the library was loaded on `device`.
extern "C" int repas_ccl_counts(int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
}

// What the launch plan needs from the card for rows of width W: out[0]
// the shared memory a block may opt into, out[1] the SM count, out[2] the
// band CTAs one SM holds by registers and threads alone (no shared
// memory), out[3] the band CTA's threads.
extern "C" int repas_ccl_limits(int W, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(
           &out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  out[3] = kThreads;
  return (int)with_seg(W, [&](auto seg) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], ccl_band<GridScope, decltype(seg)::value, false>, kThreads,
        0);
  });
}

// Clusters of `cluster` band CTAs of `band_rows` rows of width W that the
// card holds at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int repas_ccl_max_clusters(int cluster, int band_rows, int W,
                                      int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = band_smem(band_rows, W, true);
  return (int)with_seg(W, [&](auto seg) {
    auto kern = ccl_band<ClusterScope, decltype(seg)::value, false>;
    cudaError_t e = prepare(kern, smem, cluster);
    if (e != cudaSuccess) return e;
    ClusterConfig cc(cluster, 1, smem, nullptr);
    return cudaOccupancyMaxActiveClusters(out, kern, &cc.cfg);
  });
}

// The row pass alone, on the current device: B4's row unit
// (ccl_tiled.cu).
extern "C" int repas_ccl_rows(const void* mask, const void* src, void* dst,
                              int B, int H, int W, void* stream) {
  const int threads = 256;
  const int blocks = (int)(((long long)B * H * 32 + threads - 1) / threads);
  ccl_rows<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int*)src, (int*)dst, B, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* repas_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
