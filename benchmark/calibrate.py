"""Readings for setting a cell's limits and its load, on the card.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 3]
    python3 -m benchmark.calibrate --workload <name> --cameras 12,16,20 \\
        [--seconds 6]

The first form runs the cell once per seed (a short window at the cell's
own load, then the check) and prints each seed's readings, the
program's and then, for each control seed, those of the bfloat16
reference put in the program's place; all in one process, so the kernel
build is paid once. The second form runs an open-loop frame cell at each
camera count and prints its latencies and whether a backlog grew: the
sweep that fixes the rig's camera count. One JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def sweep(spec, cell: dict, cameras: list, seconds: float, seed: int):
    import torch

    from benchmark.frames import FrameCell

    cfg = spec.config(cell["config"])
    for n in cameras:
        traffic = dict(spec.traffic(cell["traffic"]), batch=n)
        work = FrameCell(cfg, traffic, seed, "cuda",
                         spec.reference(traffic["reference"]))
        work.setup()
        with torch.inference_mode():
            lat = np.asarray(work._open(seconds, record=False)) * 1e3
        q = len(lat) // 4
        print(json.dumps({
            "cameras": n, "batches": len(lat),
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p95": float(np.percentile(lat, 95)),
            "latency_ms_max": float(lat.max()),
            "first_quarter_ms": float(lat[:q].mean()),
            "last_quarter_ms": float(lat[-q:].mean())}), flush=True)
        work.release()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--cameras", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from benchmark.run import ROOT, run_cell
    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if args.cameras:
        sweep(spec, cell, args.cameras, args.seconds,
              (args.seeds or [1])[0])
        return 0
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            r = run_cell(spec, cell, seed, args.seconds, False, "cuda",
                         control=control)
            print(json.dumps({
                "seed": seed, "control": control,
                "correct": r["correct"], "attempted": r["attempted"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "readings": {k: v["value"] for k, v in r["checks"].items()}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
