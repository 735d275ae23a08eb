#!/usr/bin/env python3
"""Device time of the window copies B2, B5 and B6 of the PyTorch + CUDA port.

    python3 window_timing.py [--root DIR] [--reps N] [--plans]

Times, on seeded data at the shapes their callers give them:
  B2 main path   ``extract_windows`` (16,1536,1280) bf16, 48 windows a
                 frame of 208x384 at origins on (16, 128) tiles;
  B2 tracker     ``extract_windows`` (1,480,256) bf16, 16 exact 192x192
                 windows at arbitrary origins (the ROI step's geometry);
  B5             ``extract_windows_blk`` (16,1512,1280), f32 200x384 (tile
                 8) and bf16 208x384 (tile 16), checked starts;
  B6             ``extract_windows_exact`` (16,1520,1280) bf16, 48 exact
                 192x192 windows a frame at arbitrary starts.
Each time is the mean of 20 calls between CUDA events, queued behind a
spin kernel so that the host's gaps between launches do not count; the
bound is the union of the windows read once plus the windows written, at
3.35 TB/s. ``--root`` imports the port from another checkout (an unpacked
older commit), so two versions can be timed in turns in one run on one
card. ``--plans`` times this checkout's TMA copy under a range of plans
(band rows, ring stages, CTAs per SM) at B6's and the tracker's shapes
instead, each checked exactly against the plain copy. Prints the card's
name and power limit, then one JSON line per case or plan. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ccl_timing import queued_ms

HBM_BYTES_PER_S = 3.35e12


def union_bytes(pyr, y, x, ah, aw) -> int:
    """The pyramid pixels under some window, read once, plus the windows
    written once, in bytes; y, x (B,C) element origins that fit."""
    dev = pyr.device
    covered = torch.zeros(pyr.shape, dtype=torch.bool, device=dev)
    rows = (y.long()[..., None] + torch.arange(ah, device=dev))[..., :, None]
    cols = (x.long()[..., None] + torch.arange(aw, device=dev))[..., None, :]
    bidx = torch.arange(pyr.shape[0], device=dev)[:, None, None, None]
    covered[bidx, rows, cols] = True
    return (int(covered.sum()) + y.numel() * ah * aw) * pyr.element_size()


def cases(pe, dev):
    """(name, call, plain call, pyramid, y, x, ah, aw, C, x_align) of each
    copy; y, x the element origins each window is copied from."""
    rng = np.random.default_rng(0)
    has_paths = hasattr(pe, "window_copy_path")

    def pyramid(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    def starts(B, C, hp, w, ph, pw):
        return (rng.integers(0, w - pw, (B, C)),
                rng.integers(0, hp - ph, (B, C)))

    out = []
    # B2, main path: aligned origins, x on 128-element tiles
    pyr = pyramid((16, 1536, 1280), torch.bfloat16)
    x, y = starts(16, 48, 1536, 1280, 208, 384)
    org = torch.from_numpy(np.stack([(y // 16) * 16, (x // 128) * 128], -1)
                           .astype(np.int32)).to(dev)
    kw = {"x_align": pe.LANE_TILE} if has_paths else {}
    out.append(("B2 main path", lambda p=pyr, o=org: pe.extract_windows(
        p, o, 208, 384, **kw), lambda p=pyr, o=org: pe.extract_windows_plain(
        p, o, 208, 384), pyr, org[..., 0], org[..., 1], 208, 384, 48,
        pe.LANE_TILE))
    # B2, the tracker's ROI step: exact windows at arbitrary x
    pyr = pyramid((1, 480, 256), torch.bfloat16)
    x, y = starts(1, 16, 480, 256, 192, 192)
    org = torch.from_numpy(np.stack([y, x], -1).astype(np.int32)).to(dev)
    out.append(("B2 tracker", lambda p=pyr, o=org: pe.extract_windows(
        p, o, 192, 192), lambda p=pyr, o=org: pe.extract_windows_plain(
        p, o, 192, 192), pyr, org[..., 0], org[..., 1], 192, 192, 16, 1))
    # B5, f32 and bf16: starts in tile units, checked once
    for dtype, ph, tile_h in ((torch.float32, 200, 8),
                              (torch.bfloat16, 208, 16)):
        pyr = pyramid((16, 1512, 1280), dtype)
        x, y = starts(16, 48, 1512, 1280, ph, 384)
        st = torch.from_numpy(np.stack(
            [np.minimum(x // 128, (1280 - 384) // 128),
             np.minimum(y // tile_h, (1512 - ph) // tile_h)], -1)
            .astype(np.int32)).to(dev)
        org = pe.blk_origins(pyr.shape, st, ph, 384, tile_h).to(dev)
        out.append((f"B5 {str(dtype)[6:]}", lambda p=pyr, s=st, h=ph, t=tile_h:
                    pe.extract_windows_blk(p, s, h, 384, t, checked=True),
                    lambda p=pyr, s=st, h=ph, t=tile_h:
                    pe.extract_windows_blk_plain(p, s, h, 384, t), pyr,
                    org[..., 0], org[..., 1], ph, 384, 48, pe.LANE_TILE))
    # B6: exact windows at arbitrary [x, y] starts
    pyr = pyramid((16, 1520, 1280), torch.bfloat16)
    x, y = starts(16, 48, 1512, 1280, 192, 192)
    st = torch.from_numpy(np.stack([x, y], -1).astype(np.int32)).to(dev)
    out.append(("B6", lambda p=pyr, s=st: pe.extract_windows_exact(
        p, s, 192, 192), lambda p=pyr, s=st: pe.extract_windows_exact_plain(
        p, s, 192, 192), pyr, st[..., 1], st[..., 0], 192, 192, 48, 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose repas_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=1,
                    help="timings per case, each of 20 calls")
    ap.add_argument("--plans", action="store_true",
                    help="time the TMA copy under a range of plans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_timing: no CUDA device", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, args.root)
    from repas_tpu_torch.kernels import patch_extract as pe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        todo = cases(pe, dev)
        if args.plans:
            return time_plans(pe, [c for c in todo
                                   if c[0] in ("B6", "B2 tracker")])
        for name, fn, plain, pyr, y, x, ah, aw, C, x_align in todo:
            if not torch.equal(fn(), plain()):
                raise AssertionError(f"{name}: kernel differs from plain")
            bound = union_bytes(pyr, y, x, ah, aw) / HBM_BYTES_PER_S * 1e3
            ms = [queued_ms(fn) for _ in range(args.reps)]
            rec = {"kernel": name, "shape": list(pyr.shape),
                   "dtype": str(pyr.dtype)[6:], "window": [ah, aw],
                   "windows": C * pyr.shape[0], "root": args.root or ".",
                   "ms": ms, "bound_ms": bound,
                   "bound_share": [bound / m for m in ms]}
            if hasattr(pe, "launch_plan"):
                path, plan = pe.launch_plan(pyr, C, ah, aw, x_align)
                rec["path"] = path
                if plan is not None:
                    rec["plan"] = plan._asdict()
            print(json.dumps(rec), flush=True)
    return 0


def time_plans(pe, todo) -> int:
    """The TMA copy at each case's shape under band heights 8-128, 2-6
    ring stages and 1-4 CTAs per SM, each exact against the plain copy."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, fn, plain, pyr, y, x, ah, aw, C, _ in todo:
        ref = plain()
        starts = torch.stack([y, x], -1).to(torch.int32).contiguous()
        elem = pyr.element_size()
        chosen = pe.tma_plan(pyr.shape[0], C, ah, aw, elem, sms)
        bound = union_bytes(pyr, y, x, ah, aw) / HBM_BYTES_PER_S * 1e3
        for bh in (8, 16, 32, 64, 128):
            for stages in (2, 3, 4, 6):
                for per_sm in (1, 2, 4):
                    plan = pe.tma_plan(pyr.shape[0], C, ah, aw, elem, sms,
                                       bh=bh, stages=stages,
                                       ctas_per_sm=per_sm)
                    if plan.bh != bh or plan.smem_bytes * per_sm > 228 * 1024:
                        continue

                    def call(plan=plan):
                        return pe.run_copy(pyr, starts, ah, aw, 0, 1, 1, plan)

                    if not torch.equal(call(), ref):
                        raise AssertionError(f"{name} {plan}: differs")
                    ms = queued_ms(call)
                    print(json.dumps({
                        "kernel": name, "shape": list(pyr.shape),
                        "window": [ah, aw], "bh": bh, "stages": stages,
                        "ctas_per_sm": per_sm, "grid": plan.grid,
                        "smem_bytes": plan.smem_bytes,
                        "chosen": plan == chosen, "ms": ms,
                        "bound_ms": bound, "bound_share": bound / ms}),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
