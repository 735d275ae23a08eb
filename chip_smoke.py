#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels (repas_tpu_torch/kernels/csrc) from
   this checkout;
3. runs the 720p frame pipeline (repas_tpu_torch.pipeline.process_frames)
   once at batch 16 to capture each kernel's inputs at the main path's
   shapes, then holds each kernel against its plain PyTorch version on
   the card (B1, B2 exact; B3 within 1e-6 relative) and times both with
   CUDA events;
4. resets the launch counts, runs the pipeline with synchronizing CUDA
   calls turned into errors (the step must not wait for the device),
   reads the counts, checks the results (tag 9 in every frame, depth-corrected z within 5 mm of
   0.45 m, one frame equal to the port's CPU result) and times it;
5. prints one JSON line of kernel results, then, last, one JSON line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line. It needs one CUDA device and refuses to run without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 16
H, W = 720, 1280
TAG_ID = 9
TAG_Z = 0.45
STEPS = 10


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def bench_frames(batch: int):
    """The bench frame (tag 9 at 0.45 m, 720p) repeated with per-frame
    noise, as the JAX package's bench builds it."""
    from repas_tpu_torch.detect.render import example_frame

    rgb, depth, K = example_frame(H, W, tag_id=TAG_ID, z=TAG_Z)
    rng = np.random.default_rng(0)
    rgbs = np.stack([rgb] * batch)
    rgbs = np.clip(rgbs.astype(np.int16)
                   + rng.integers(-8, 8, rgbs.shape), 0, 255).astype(np.uint8)
    depths = np.stack([depth] * batch)
    return rgbs, depths, K


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Capture:
    """Records the arguments of the first call of module.name and passes
    every call through; restores the attribute on exit."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.args = None

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            if self.args is None:
                self.args = (args, kwargs)
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def check_kernels(captured):
    """Each kernel against its plain version on the card, at the main
    path's inputs; returns the kernel records (launches filled later)."""
    from repas_tpu_torch.kernels import (ccl, ccl_cuda, patch_extract,
                                         pointcloud)

    (mask, iters), _ = captured["ccl"]
    (pyr, origins, ah, aw), _ = captured["patch_extract"]
    (depth, rgb32, K), kw = captured["pointcloud"]
    scale = kw["scale"]

    specs = [
        ("B1 ccl", mask, "repas_tpu_torch/kernels/csrc/ccl.cu",
         "repas_tpu/kernels/ccl_pallas.py:35",
         lambda: ccl_cuda.connected_components_cuda(mask, iters),
         lambda: ccl.connected_components_plain(mask, iters), 0.0),
        ("B2 patch_extract", pyr,
         "repas_tpu_torch/kernels/csrc/patch_extract.cu",
         "repas_tpu/kernels/patch_extract.py:61",
         lambda: patch_extract.extract_windows(pyr, origins, ah, aw),
         lambda: patch_extract.extract_windows_plain(pyr, origins, ah, aw),
         0.0),
        ("B3 pointcloud", depth, "repas_tpu_torch/kernels/csrc/pointcloud.cu",
         "repas_tpu/kernels/pointcloud.py:102",
         lambda: pointcloud.fused_pointcloud(depth, rgb32, K, scale),
         lambda: pointcloud.fused_pointcloud_plain(depth, rgb32, K, scale),
         1e-6),
    ]
    records = []
    for name, first_arg, source, replaces, kern, plain, rtol in specs:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{name}: kernel gives {tuple(got.shape)} "
                                 f"{got.dtype}, plain {tuple(ref.shape)} "
                                 f"{ref.dtype}")
        diff = (got.to(torch.float64) - ref.to(torch.float64)).abs()
        max_err = float(diff.max())
        bound = (rtol * ref.to(torch.float64).abs()) if rtol else 0.0
        if not bool(torch.all(diff <= bound)):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max abs err {max_err}")
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        log({"kernel": name, "input_shape": list(first_arg.shape),
             "max_abs_err": max_err, "tolerance_rtol": rtol, "ms": ms,
             "plain_ms": plain_ms})
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": max_err, "ms": ms,
                        "plain_ms": plain_ms})
    return records


def check_results(out, out_cpu0, dev_name):
    """Detections and pose of the bench batch, and frame 0 against the
    port's CPU run."""
    det, pose = out.detections, out.pose
    if tuple(out.pointcloud.shape) != (BATCH, 6, H * W):
        raise AssertionError(f"pointcloud shape {tuple(out.pointcloud.shape)}")
    if not bool(torch.isfinite(out.pointcloud).all()):
        raise AssertionError("pointcloud has non-finite values")
    best = torch.argmax(torch.where(det.valid, det.decision_margin, -1.0),
                        dim=1)
    rows = torch.arange(BATCH, device=best.device)
    best_valid = det.valid[rows, best].cpu()
    best_id = det.ids[rows, best].cpu()
    if not bool(best_valid.all()) or not bool((best_id == TAG_ID).all()):
        raise AssertionError(f"best slots: valid {best_valid.tolist()}, "
                             f"ids {best_id.tolist()}")
    z = pose.anchor_P_depth[:, 2].cpu()
    if not bool(((z - TAG_Z).abs() <= 0.005).all()):
        raise AssertionError(f"anchor_P_depth z {z.tolist()}")

    d0 = out_cpu0.detections
    ids_gpu, ids_cpu = det.ids[0].cpu(), d0.ids[0]
    valid_gpu, valid_cpu = det.valid[0].cpu(), d0.valid[0]
    if not (torch.equal(ids_gpu, ids_cpu) and torch.equal(valid_gpu,
                                                          valid_cpu)):
        raise AssertionError(f"frame 0 on {dev_name} vs CPU: ids "
                             f"{ids_gpu.tolist()} vs {ids_cpu.tolist()}")
    cdiff = (det.corners[0].cpu() - d0.corners[0]).abs()[valid_cpu]
    corner_err = float(cdiff.max()) if cdiff.numel() else 0.0
    if corner_err > 0.05:
        raise AssertionError(f"frame 0 corners differ from CPU by "
                             f"{corner_err} px")
    log({"phase": "results", "best_ids": best_id.tolist(),
         "anchor_z_m": z.tolist(), "frame0_vs_cpu_corner_max_px": corner_err,
         "frame0_ids": ids_gpu.tolist()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    from repas_tpu_torch.core.config import PipelineConfig
    from repas_tpu_torch.kernels import _build, ccl_cuda, patch_extract
    from repas_tpu_torch import pipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])

    dev = torch.device("cuda", 0)
    dev_name = torch.cuda.get_device_name(0)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": dev_name})

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log({"phase": "build", "library": str(lib.name),
         "seconds": time.perf_counter() - t0,
         "nvcc_seconds": _build.build_seconds})
    if _build.build_log:
        print(_build.build_log.strip(), flush=True)

    rgbs_np, depths_np, K_np = bench_frames(BATCH)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    depths = torch.from_numpy(depths_np).to(dev)
    K = torch.from_numpy(K_np).to(dev)
    cfg = PipelineConfig()

    with torch.no_grad():
        # warm-up run that records each kernel's main-path inputs
        with Capture(ccl_cuda, "connected_components_cuda") as c1, \
                Capture(patch_extract, "extract_windows") as c2, \
                Capture(pipeline, "fused_pointcloud") as c3:
            pipeline.process_frames(rgbs, depths, K, cfg)
            torch.cuda.synchronize()
        captured = {"ccl": c1.args, "patch_extract": c2.args,
                    "pointcloud": c3.args}
        missing = [k for k, v in captured.items() if v is None]
        if missing:
            raise AssertionError(f"main path never called {missing}")
        records = check_kernels(captured)

        # the main path, counted, with any host sync inside it an error
        _build.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipeline.process_frames(rgbs, depths, K, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        keys = {"B1 ccl": "ccl", "B2 patch_extract": "patch_extract",
                "B3 pointcloud": "pointcloud"}
        for rec in records:
            rec["launches"] = counts[keys[rec["name"]]]
        zero = [r["name"] for r in records if r["launches"] < 1]
        if zero:
            raise AssertionError(f"kernels not launched by the main path: "
                                 f"{zero} (counts {counts})")

        out_cpu0 = pipeline.process_frames(rgbs[:1].cpu(), depths[:1].cpu(),
                                           K_np, cfg)
        check_results(out, out_cpu0, dev_name)

        # step time: host clock around synchronized steps, and CUDA events
        step_ms = []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipeline.process_frames(rgbs, depths, K, cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        ev_ms = cuda_ms(lambda: pipeline.process_frames(rgbs, depths, K, cfg),
                        iters=STEPS, warmup=1)
    med = float(np.median(step_ms))
    log({"phase": "pipeline", "batch": BATCH, "height": H, "width": W,
         "step_ms_median": med, "step_ms_all": step_ms,
         "step_ms_cuda_events": ev_ms, "frames_per_s": BATCH * 1e3 / med,
         "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})

    log({"kernels": records})
    log({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
