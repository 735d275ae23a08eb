"""Stage-level timing of the headline detector pipeline on the card.

Port of ``tools/profile_stages.py``. Runs every cumulative stage prefix
of the detector (``gray`` .. ``refine2``) on the whole batch, times each
on the host clock around ``torch.cuda.synchronize()`` (stage cost = the
successive difference), then ``detect_tags`` whole, the fused point cloud
(kernel B3) and ``pipeline.process_frames``. The JAX tool jits each
prefix; the port runs eagerly, so a stage delta includes the host's
launch time.

    python -m repas_tpu_torch.tools.profile_stages [--batch 16] \\
        [--iters 10] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repas_tpu_torch.core.config import DetectorConfig, PipelineConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.detect.detector import (_EDGE_TS, _PATCH,
                                             _candidate_patches,
                                             _quad_from_support,
                                             _refine_edges, _refine_pyramid,
                                             _support_points, detect_tags)
from repas_tpu_torch.detect.render import example_frame
from repas_tpu_torch.kernels.ccl import connected_components, top_k_components
from repas_tpu_torch.kernels.image import (adaptive_threshold,
                                           bilinear_sample_patch, decimate,
                                           rgb_to_gray)
from repas_tpu_torch.kernels.pointcloud import fused_pointcloud
from repas_tpu_torch.pipeline import process_frames
from repas_tpu_torch.tools import card_line, ms_per_frame

H, W = 720, 1280
STAGES = ("gray", "thresh", "ccl", "topk", "support", "quad", "pyramid",
          "patches", "samp1", "refine1", "refine2")


def _frames(batch: int, device, h: int = H, w: int = W):
    """The bench frame x batch with noise in [-8, 8) from seed 0 -> (rgbs
    (B,H,W,3) uint8, depths (B,H,W) uint16, K (3,3) float32 numpy)."""
    rgb, depth, K = example_frame(h, w)
    rng = np.random.default_rng(0)
    rgbs = np.clip(np.stack([rgb] * batch).astype(np.int16)
                   + rng.integers(-8, 8, (batch, h, w, 3)), 0, 255
                   ).astype(np.uint8)
    return (torch.from_numpy(rgbs).to(device),
            torch.from_numpy(np.stack([depth] * batch)).to(device), K)


def _samp_only(patches: torch.Tensor, q: torch.Tensor, dec: int):
    """Sampler-only cost of refine pass 1: its sample positions on (N,h,w)
    patches around (N,4,2) quads, no gradient, line fit or intersection
    chain."""
    rolled = torch.roll(q, -1, dims=-2)
    ts = torch.tensor(_EDGE_TS, dtype=torch.float32, device=q.device)
    search = 2.0 + dec
    offs = torch.linspace(-search, search, 2 * int(round(search)) + 1,
                          device=q.device)
    d = rolled - q                                         # (N,4,2)
    n_hat = torch.stack([-d[..., 1], d[..., 0]], dim=-1)
    n_hat = n_hat / (torch.linalg.vector_norm(n_hat, dim=-1, keepdim=True)
                     + 1e-9)
    base = q[..., None, :] + ts[:, None] * d[..., None, :]     # (N,4,S,2)
    pts = base[..., None, :] + offs[:, None] * n_hat[..., None, None, :]
    return torch.sum(bilinear_sample_patch(patches, pts))


def _stage_prefix(img: torch.Tensor, config: DetectorConfig, upto: str):
    """Run the detector's stages on (B,H,W,3) uint8 frames up to `upto`
    and return the stage's output summed over the batch (a scalar)."""
    gray = rgb_to_gray(img)
    B, h, w = gray.shape
    dec = max(1, int(config.quad_decimate))
    gray_lo = decimate(gray, dec) if dec > 1 else gray
    hl, wl = gray_lo.shape[-2:]
    if upto == "gray":
        return torch.sum(gray_lo)
    binary, ambiguous = adaptive_threshold(gray_lo, tile=config.tile,
                                           min_contrast=config.min_contrast)
    dark = (~binary) & (~ambiguous)
    if upto == "thresh":
        return torch.sum(dark)
    labels = connected_components(dark, iters=config.ccl_iters,
                                  converge=True)
    if upto == "ccl":
        return torch.sum(labels)
    roots, areas, valid_c, bbox = top_k_components(
        labels, config.max_components,
        min_area=config.min_area_px / (dec * dec),
        max_area=config.max_area_frac * hl * wl, ring_filter=True,
        min_side=8.0 / dec, return_bbox=True)
    if upto == "topk":
        return torch.sum(roots) + torch.sum(areas)
    sup = _support_points(labels, roots, bbox)
    if upto == "support":
        return torch.sum(sup)
    quads = _quad_from_support(sup)
    if dec > 1:
        quads = quads * dec + (dec - 1) / 2.0
    if upto == "quad":
        return torch.sum(quads)

    # ---- refine/decode sub-stages (mirrors detect_tags' patch tier) ----
    ph, pw = min(_PATCH, h), min(_PATCH, w)
    pyr, row_off, sizes = _refine_pyramid(gray, ph, pw)
    if upto == "pyramid":
        return torch.sum(pyr.to(torch.float32))
    patches, off, scale, _ = _candidate_patches(pyr, row_off, sizes, quads,
                                                ph, pw)
    if upto == "patches":
        return torch.sum(patches.to(torch.float32))
    q_rel = (quads - (scale - 1) / 2.0) / scale - off
    n = q_rel.shape[0] * q_rel.shape[1]
    flat = patches.reshape(n, *patches.shape[2:])
    q_rel = q_rel.reshape(n, 4, 2)
    if upto == "samp1":
        return _samp_only(flat, q_rel, dec)
    q_ref = _refine_edges(flat, q_rel, search=2.0 + dec, offset_step=1.0)
    if upto == "refine1":
        return torch.sum(q_ref)
    q_ref = _refine_edges(flat, q_ref, search=1.0, offset_step=0.25)
    if upto == "refine2":
        return torch.sum(q_ref)
    raise ValueError(upto)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ms/frame of the detector's "
                                "stage prefixes, detect_tags, the point "
                                "cloud and the pipeline at 720p")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    dev = host_data_device(args.device)
    print(card_line(dev), flush=True)
    print("backend:", dev.type, flush=True)
    rgbs, depths, K = _frames(args.batch, dev)
    Kt = torch.from_numpy(K).to(dev)
    cfg = PipelineConfig()

    def timeit(name, fn, *fargs):
        dt, s = ms_per_frame(fn, fargs, dev, args.iters, args.batch)
        print(f"{name:28s} {dt:8.3f} ms/frame   (sum={s:.1f})", flush=True)
        return dt

    with torch.no_grad():
        prev = 0.0
        for st in STAGES:
            t = timeit(f"prefix:{st}", lambda r, st=st: _stage_prefix(
                r, cfg.detector, st), rgbs)
            print(f"    stage delta {st}: {t - prev:+.3f} ms", flush=True)
            prev = t
        t_det = timeit("detect_tags (full)", lambda r: torch.sum(
            detect_tags(r, cfg.detector).decision_margin), rgbs)
        print(f"    stage delta refine+decode: {t_det - prev:+.3f} ms",
              flush=True)
        timeit("pointcloud", lambda d, r: torch.sum(
            fused_pointcloud(d, r, Kt, scale=0.001)), depths, rgbs)
        timeit("full pipeline", lambda r, d: torch.sum(
            process_frames(r, d, Kt, cfg).pose.anchor_P_depth), rgbs, depths)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
