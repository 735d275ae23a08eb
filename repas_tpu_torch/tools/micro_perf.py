"""Micro-benchmarks of variants of the pipeline's hot stages, on the card.

Port of ``tools/micro_perf.py``: the same sections under the same names
(``gray decim patches dmapatch2 fusion pnpiters pointcloud``; default
``gray patches pointcloud``), the same data from the same seeds, the same
printed lines (name, ms/frame, the output's sum, ``maxdiff`` against the
first variant where the JAX tool prints it). Each variant keeps the
reference's formulation in torch: ``gray_matmul`` is a (..., 12) @
(12, 4) product, ``gray_conv`` and ``dec_conv`` strided ``conv2d`` (full
f32: the package sets no TF32), ``dec_reduce_window`` a 2x2 window sum.

The JAX tool's two Pallas kernels are hand-written CUDA here, and their
lines keep the JAX tool's names:
  "pallas DMA f32 aligned 200x384", "pallas DMA bf16 aligned 208x384"
      kernel B5, ``kernels.patch_extract.extract_windows_blk``: windows
      at starts in (tile_h, 128) tile units. The JAX tool's block starts
      can run past the pyramid's edge (x // 128 up to 8 for a 384-wide
      window in 1280 columns); the TPU kernel raises on them and so does
      B5, so this tool clamps each block start to the last that fits.
      B5's fit check reads the starts on the host; it runs once, before
      the timing (``blk_origins``), so these lines time the launches
      alone, as the JAX tool's jitted lines do;
  "pallas aligned DMA+rewindow"
      kernel B6, ``kernels.patch_extract.extract_windows_exact``: the
      exact (192, 192) window at an arbitrary start (one copy; no cover
      and roll), checked against the plain gather ("match:").
The "vmap dynamic_slice" / "xla dynamic_slice" lines are that plain
gather (one indexing call). A kernel that fails raises.

    python -m repas_tpu_torch.tools.micro_perf [section ...] \\
        [--iters 20] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.transforms import average_rotations_quat
from repas_tpu_torch.kernels.image import pack_rgb_u32, rgb_to_gray
from repas_tpu_torch.kernels.patch_extract import (
    LANE_TILE, blk_origins, extract_windows_blk, extract_windows_exact,
    extract_windows_exact_plain)
from repas_tpu_torch.kernels.pointcloud import fused_pointcloud
from repas_tpu_torch.pose.depth_correct import depth_corrected_translation
from repas_tpu_torch.pose.fusion import fuse_tag_poses_jit
from repas_tpu_torch.pose.pnp import solve_pnp_ippe_square_jit
from repas_tpu_torch.tools import card_line, ms_per_frame

BATCH = 16
H, W = 720, 1280
SECTIONS = ("gray", "decim", "patches", "dmapatch2", "fusion", "pnpiters",
            "pointcloud")

# ---------------------------------------------------------------- gray
LUM = np.array([0.299, 0.587, 0.114], np.float32)
_W12 = np.zeros((12, 4), np.float32)
for _j in range(12):
    _W12[_j, _j // 3] = LUM[_j % 3]


def gray_naive(img):
    x = img.to(torch.float32)
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def gray_bitcast(img):
    return rgb_to_gray(img)


def gray_matmul(img):
    h, w = img.shape[-3:-1]
    x = img.reshape(*img.shape[:-3], h * (w // 4), 12).to(torch.float32)
    return (x @ torch.from_numpy(_W12).to(img.device)).reshape(
        *img.shape[:-3], h, w)


def gray_matmul_bf16(img):
    h, w = img.shape[-3:-1]
    x = img.reshape(*img.shape[:-3], h * (w // 4), 12).to(torch.bfloat16)
    k = torch.from_numpy(_W12).to(img.device, torch.bfloat16)
    return (x @ k).reshape(*img.shape[:-3], h, w).to(torch.float32)


def gray_conv(img):
    h, w = img.shape[-3:-1]
    x = img.reshape(-1, 1, h, w * 3).to(torch.float32)
    k = torch.from_numpy(LUM).to(img.device).reshape(1, 1, 1, 3)
    return F.conv2d(x, k, stride=(1, 3)).reshape(*img.shape[:-3], h, w)


def gray_weighted_pairsum(img):
    # per-byte weighted values, then the sum over each pixel's 3 bytes
    h, w = img.shape[-3:-1]
    wrep = torch.from_numpy(np.tile(LUM, w)).to(img.device)
    x = img.reshape(*img.shape[:-3], h, w * 3).to(torch.float32) * wrep
    return torch.sum(x.reshape(*img.shape[:-3], h, w, 3), dim=-1)


def gray_u32pad(img):
    # pad the channel dim to 4 bytes, then view as one 32-bit word/pixel
    u = F.pad(img, (0, 1)).view(torch.int32)[..., 0]
    r = (u & 255).to(torch.float32)
    g = ((u >> 8) & 255).to(torch.float32)
    b = ((u >> 16) & 255).to(torch.float32)
    return 0.299 * r + 0.587 * g + 0.114 * b


# ------------------------------------------------------------ decimate
def dec_reshape(g):
    h, w = g.shape[-2:]
    return g.reshape(*g.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def dec_strided(g):
    return 0.25 * (g[..., 0::2, 0::2] + g[..., 0::2, 1::2]
                   + g[..., 1::2, 0::2] + g[..., 1::2, 1::2])


def dec_rowcol(g):
    a = g[..., 0::2, :] + g[..., 1::2, :]        # (h/2, w)
    return 0.25 * (a[..., 0::2] + a[..., 1::2])


def dec_reduce_window(g):
    s = F.avg_pool2d(g.reshape(-1, 1, *g.shape[-2:]), 2, stride=2,
                     divisor_override=1)
    return s.reshape(*g.shape[:-2], *s.shape[-2:]) * 0.25


def dec_conv(g):
    k = torch.full((1, 1, 2, 2), 0.25, dtype=torch.float32, device=g.device)
    s = F.conv2d(g.reshape(-1, 1, *g.shape[-2:]), k, stride=2)
    return s.reshape(*g.shape[:-2], *s.shape[-2:])


# ------------------------------------------------------------- patches
PH = PW = 192
NC = 48
PYR_H = 1512


def patches_xla(pyr, starts):
    """The JAX tool's vmapped dynamic_slice: (B,C,2) [x, y] starts ->
    (B,C,PH,PW) windows, one indexing call (B6's plain version)."""
    return extract_windows_exact_plain(pyr, starts, PH, PW)


def fit_blocks(st_blk, hp, w, ph, pw, tile_h):
    """Clamp (B,C,2) [x_block, y_block] starts to the last block whose
    (ph, pw) window fits an (hp, w) pyramid."""
    return torch.stack([
        torch.clamp(st_blk[..., 0], max=(w - pw) // LANE_TILE),
        torch.clamp(st_blk[..., 1], max=(hp - ph) // tile_h)],
        dim=-1).contiguous()


# ---------------------------------------------------------- pointcloud
def pc_current(depth, rgb, K):
    return fused_pointcloud(depth, rgb, K)


def pc_planar(depth, rgb, K):
    return fused_pointcloud(depth, pack_rgb_u32(rgb), K)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="micro-benchmarks of the hot "
                                "stages' variants (see the module "
                                "docstring)")
    p.add_argument("sections", nargs="*",
                   help=f"any of {' '.join(SECTIONS)} (default: gray "
                        "patches pointcloud)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    unknown = sorted(set(args.sections) - set(SECTIONS))
    if unknown:
        p.error(f"unknown sections {unknown}; choose from {SECTIONS}")
    sections = args.sections or ["gray", "patches", "pointcloud"]
    dev = host_data_device(args.device)
    print(card_line(dev), flush=True)
    print("backend:", dev.type, flush=True)

    def timeit(name, fn, *fargs, ref=None):
        dt, s = ms_per_frame(fn, fargs, dev, args.iters, BATCH)
        extra = "" if ref is None else f"   maxdiff={abs(s - ref):.3f}"
        print(f"{name:34s} {dt:8.4f} ms/frame  (sum={s:.1f}){extra}",
              flush=True)
        return s

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(
        rng.integers(0, 255, (BATCH, H, W, 3), np.uint8)).to(dev)
    depths = torch.from_numpy(
        rng.integers(300, 3000, (BATCH, H, W)).astype(np.uint16)).to(dev)
    K = torch.tensor([[912.0, 0, 640.0], [0, 912.0, 360.0], [0, 0, 1]],
                     dtype=torch.float32, device=dev)

    with torch.no_grad():
        if "gray" in sections:
            print("--- gray ---")
            ref = None
            for name, fn in [("bitcast(current)", gray_bitcast),
                             ("naive f32", gray_naive),
                             ("weighted+minor3sum", gray_weighted_pairsum),
                             ("u32pad", gray_u32pad)]:
                s = timeit(name, lambda x, fn=fn: torch.sum(fn(x)), imgs,
                           ref=ref)
                if ref is None:
                    ref = s

        if "decim" in sections:
            print("--- decimate (gray+decimate fused, like the detector) ---")
            ref = None
            for name, fn in [("reshape-mean(current)", dec_reshape),
                             ("strided 4-add", dec_strided),
                             ("row then col", dec_rowcol),
                             ("reduce_window", dec_reduce_window),
                             ("conv 2x2 s2", dec_conv)]:
                s = timeit(name, lambda x, fn=fn: torch.sum(
                    fn(rgb_to_gray(x))), imgs, ref=ref)
                if ref is None:
                    ref = s

        if "patches" in sections:
            print("--- patches ---")
            pyr = torch.from_numpy(rng.standard_normal(
                (BATCH, PYR_H, W)).astype(np.float32)).to(dev)
            starts = torch.from_numpy(
                np.stack([rng.integers(0, W - PW, (BATCH, NC)),
                          rng.integers(0, PYR_H - PH, (BATCH, NC))], axis=-1)
                .astype(np.int32)).to(dev)
            r0 = timeit("vmap dynamic_slice f32", lambda p, s: torch.sum(
                patches_xla(p, s)), pyr, starts)
            pyr16 = pyr.to(torch.bfloat16)
            timeit("vmap dynamic_slice bf16", lambda p, s: torch.sum(
                patches_xla(p, s).to(torch.float32)), pyr16, starts, ref=r0)
            # aligned variants: starts in tile-block units, larger cover so
            # the target window is always inside
            st_b32 = fit_blocks(torch.cat([starts[..., :1] // 128,
                                           starts[..., 1:] // 8], dim=-1),
                                PYR_H, W, 200, 384, 8)
            blk_origins(pyr.shape, st_b32, 200, 384, 8)
            timeit("pallas DMA f32 aligned 200x384", lambda p, s: torch.sum(
                extract_windows_blk(p, s, 200, 384, 8, checked=True)),
                pyr, st_b32)
            st_b16 = fit_blocks(torch.cat([starts[..., :1] // 128,
                                           starts[..., 1:] // 16], dim=-1),
                                PYR_H, W, 208, 384, 16)
            blk_origins(pyr16.shape, st_b16, 208, 384, 16)
            timeit("pallas DMA bf16 aligned 208x384", lambda p, s: torch.sum(
                extract_windows_blk(p, s, 208, 384, 16, checked=True)
                .to(torch.float32)), pyr16, st_b16)

        if "dmapatch2" in sections:
            print("--- aligned DMA + VMEM rewindow (exact patches) ---")
            php = ((PYR_H + 15) // 16) * 16
            pyr = torch.from_numpy(rng.standard_normal(
                (BATCH, php, W)).astype(np.float32)).to(dev).to(
                torch.bfloat16)
            starts = torch.from_numpy(
                np.stack([rng.integers(0, W - PW, (BATCH, NC)),
                          rng.integers(0, PYR_H - PH, (BATCH, NC))], axis=-1)
                .astype(np.int32)).to(dev)
            ref_out = patches_xla(pyr, starts)
            got = extract_windows_exact(pyr, starts, PH, PW)
            print("match:", bool(torch.equal(ref_out.view(torch.int16),
                                              got.view(torch.int16))),
                  flush=True)
            timeit("xla dynamic_slice bf16", lambda p, s: torch.sum(
                patches_xla(p, s).to(torch.float32)), pyr, starts)
            timeit("pallas aligned DMA+rewindow", lambda p, s: torch.sum(
                extract_windows_exact(p, s, PH, PW).to(torch.float32)),
                pyr, starts)

        if "fusion" in sections:
            print("--- fusion ---")
            D = 8
            half = 0.0303 / 2
            obj = np.array([[-half, -half], [half, -half],
                            [half, half], [-half, half]], np.float32)
            corners = []
            rng2 = np.random.default_rng(3)
            for _ in range(BATCH):
                cs = []
                for _ in range(D):
                    c0 = rng2.uniform(200, 1000), rng2.uniform(150, 550)
                    sz = rng2.uniform(30, 120)
                    cs.append(obj / half * sz / 2 + np.asarray(c0))
                corners.append(cs)
            corners = torch.from_numpy(
                np.asarray(corners, np.float32)).to(dev)          # (B,D,4,2)
            ids = torch.arange(D, dtype=torch.int32,
                               device=dev).repeat(BATCH, 1)
            areas = torch.full((BATCH, D), 900.0, device=dev)
            valid = torch.ones((BATCH, D), dtype=torch.bool, device=dev)
            depth_m = depths.to(torch.float32) * 0.001
            dist = torch.zeros(8, dtype=torch.float32, device=dev)

            # the JAX tool times these through jax.jit: the compiled steps
            timeit("pnp ippe x8", lambda c: torch.sum(
                solve_pnp_ippe_square_jit(c, K, 0.0303, dist=dist)[1]),
                corners)
            ts = torch.tensor([0.1, 0.1, 1.0], device=dev).repeat(BATCH, D, 1)
            # the JAX tool sums frame 0's corrected translations only
            timeit("depth_correct x8", lambda t, dm: torch.sum(
                depth_corrected_translation(t, dm, K, win=5)[0][0]),
                ts, depth_m)
            Rs = torch.eye(3, device=dev).repeat(BATCH, D, 1, 1)
            ws = torch.ones((BATCH, D), device=dev)
            timeit("quat average", lambda R, w: torch.sum(
                average_rotations_quat(R, w, mask=w > 0)), Rs, ws)
            timeit("fuse_tag_poses full", lambda c, i, a, v, dm: torch.sum(
                fuse_tag_poses_jit(c, i, a, v, dm, K, 0.0303, flip_z_ids=(),
                                   dist=dist).anchor_P_depth),
                corners, ids, areas, valid, depth_m)

        if "pnpiters" in sections:
            print("--- pnp refine_iters scaling ---")
            rng3 = np.random.default_rng(5)
            corners = torch.from_numpy(rng3.uniform(
                100, 600, (BATCH, 8, 4, 2)).astype(np.float32)).to(dev)
            for it in (8, 4, 2, 0):
                timeit(f"ippe dist=None iters={it}", lambda c, it=it:
                       torch.sum(solve_pnp_ippe_square_jit(
                           c, K, 0.0303, refine_iters=it)[1]), corners)
            zeros = torch.zeros(8, device=dev)
            timeit("ippe dist=zeros iters=8", lambda c: torch.sum(
                solve_pnp_ippe_square_jit(c, K, 0.0303, refine_iters=8,
                                          dist=zeros)[1]), corners)

        if "pointcloud" in sections:
            print("--- pointcloud ---")
            rp = timeit("current (H*W,6)", lambda d, r: torch.sum(
                pc_current(d, r, K)), depths, imgs)
            timeit("planar (6,H*W)", lambda d, r: torch.sum(
                pc_planar(d, r, K)), depths, imgs, ref=rp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
