#!/usr/bin/env python3
"""Device time of the CCL kernels B1 and B4 of the PyTorch + CUDA port.

    python3 ccl_timing.py [--root DIR] [--reps N] [--plans]

Times ``connected_components_cuda`` (B1) at the shapes the main path and
the robust ladder give it, (16,360,640), (8,360,640) and (16,256,256), and
``connected_components_tiled_cuda`` (B4) at the ladder's (4,720,1280), 5
rounds each, on random masks of density 0.5 and on all-foreground masks
made from a seed. Each time is the mean of 20 calls between CUDA events,
the calls queued behind a spin kernel so that the host's gaps between
launches do not count. ``--root`` imports the port from another checkout
(an unpacked older commit), so two versions can be timed in turns in one
run on one card. ``--plans`` times this checkout's band kernel under
every launch plan the card takes at those shapes instead (cluster sizes
1 to 16 with cudaOccupancyMaxActiveClusters for B1, band heights for
B4), beside the plan ``plan_bands`` picks. Prints the card's name and
power limit, then one JSON line per shape or plan. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

B1_SHAPES = [(16, 360, 640), (8, 360, 640), (16, 256, 256)]
B4_SHAPES = [(4, 720, 1280)]
ITERS = 5


def queued_ms(fn, calls: int = 20) -> float:
    """Mean device time of fn() in ms over `calls` calls queued behind a
    spin kernel that covers their host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * (2 * calls * host_s + 0.002)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose repas_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=1,
                    help="timings per shape, each of 20 calls")
    ap.add_argument("--plans", action="store_true",
                    help="time every launch plan of the band kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ccl_timing: no CUDA device", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, args.root)
    from repas_tpu_torch.kernels import ccl_cuda, ccl_tiled

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    if args.plans:
        return time_plans(dev, gen)
    cases = ([("B1", s, ccl_cuda.connected_components_cuda)
              for s in B1_SHAPES]
             + [("B4", s, ccl_tiled.connected_components_tiled_cuda)
                for s in B4_SHAPES])
    for name, shape, fn in cases:
        for density in (0.5, 1.0):
            mask = (torch.rand(shape, generator=gen) < density).to(dev)
            ms = [queued_ms(lambda: fn(mask, ITERS))
                  for _ in range(args.reps)]
            print(json.dumps({"kernel": name, "shape": list(shape),
                              "density": density, "iters": ITERS,
                              "root": args.root or ".", "ms": ms}),
                  flush=True)
    return 0


def time_plans(dev, gen) -> int:
    """Every cluster size at B1's shapes and a range of band heights at
    B4's, each checked exactly against the plain CCL, density 0.5."""
    from repas_tpu_torch.kernels import ccl, ccl_cuda

    for shape, cluster in ([(s, True) for s in B1_SHAPES]
                           + [(s, False) for s in B4_SHAPES]):
        B, h, w = shape
        mask = (torch.rand(shape, generator=gen) < 0.5).to(dev)
        ref = ccl.connected_components_plain(mask, ITERS)
        lim = ccl_cuda.card_limits(0, w)
        chosen = ccl_cuda.plan_for(mask, cluster)
        plans = []
        for k in range(1, 17) if cluster else range(8, 49):
            rows = -(-h // k) if cluster else k
            bands = k if cluster else -(-h // rows)
            smem = ccl_cuda.band_smem(rows, w, cluster)
            per_sm = ccl_cuda._per_sm(smem, lim["smem_block"],
                                      lim["blocks_per_sm"])
            if smem > lim["smem_block"] or (
                    not cluster and (-(-h // bands) != rows
                                     or bands * B > per_sm * lim["sm_count"])):
                continue
            plans.append(ccl_cuda.BandPlan(
                "cluster" if cluster else "grid", k if cluster else 0,
                rows, bands, B, 1, smem))
        for plan in plans:
            out = ccl_cuda.run_plan(mask, ITERS, plan)
            if not torch.equal(out, ref):
                raise AssertionError(f"{shape} {plan}: labels differ")
            rec = {"shape": list(shape), "mode": plan.mode,
                   "cluster": plan.cluster, "band_rows": plan.band_rows,
                   "bands": plan.bands, "chosen": plan == chosen,
                   "ms": queued_ms(lambda: ccl_cuda.run_plan(mask, ITERS,
                                                             plan))}
            if cluster:
                rec["max_active_clusters"] = ccl_cuda.max_active_clusters(
                    plan.cluster, plan.band_rows, w, 0)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
