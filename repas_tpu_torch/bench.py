"""Headline benchmark of the port: the batched 720p detect + PnP + point
cloud loop on one NVIDIA GPU.

Port of ``bench.py``, function by function. It prints the headline JSON
line first (flushed, so an overrun in the extras cannot lose it), then,
once the extras have run inside the wall-clock budget
(``REPAS_BENCH_BUDGET_S``, default 900 s), a final superset line:

  metric, value, unit   frames/s of the compiled step
                        ``pipeline.process_frames_jit`` (a CUDA graph on
                        the card, ``process_frames`` on the CPU) at 720p,
                        batch 16, default config, on the bench frame:
                        one warm call (which builds the kernels, captures
                        the graph and is gated: tag 9 best in every
                        frame, anchor z within 5 mm of 0.45 m), then 10
                        calls queued and one draining host read
  vs_baseline           value / cpu_fps
  cpu_fps               the same loop on this host's CPU (batch 2, at
                        least 10 s), in a subprocess
  cpu_fps_cached        false whenever cpu_fps is set: nothing is cached
  ref_stack_cpu_fps     cv2.aruco detect + solvePnP + numpy deprojection
                        on this host's CPU (null without cv2), and
  vs_ref_stack          value over it
  vs_design_target      value / 30 (the reference's real-time target)
  mpts_per_s            value x H x W / 1e6
  robust_real_fps       null: the real captures are not in the repository
  robust_synth_fps      the compiled staged ladder + best-order PnP
                        (CUDA graphs on the card) on 8 synthetic
                        720p frames, and
  robust_tags_found     its valid best slots (7: frame 7 has no tag)
  registration_1m_wall_s  seconds of one 1M vs 1M ``register_clouds``
                        after a gated warm run, and
  registration_1m_status  ok / low_fitness=... / exception=<type>
  device                the card's ``nvidia-smi --query-gpu=name,
                        power.limit`` line ("cpu" with --device cpu)

Departures from ``bench.py``, each stated again at its line: the
registration's wall seconds under ``registration_1m_wall_s``, not
``registration_1m_pts_s``; ``robust_real_fps`` null beside
``robust_synth_fps``; the ``device`` field; and no state file, so every
field is measured in this run or null and ``cpu_fps_cached`` is false
whenever ``cpu_fps`` is set.

    python -m repas_tpu_torch.bench [--device cuda]

Without a card it raises unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.cloud.registration import register_clouds
from repas_tpu_torch.core.config import (DetectorConfig, PipelineConfig,
                                         PnPConfig)
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.core.transforms import rodrigues
from repas_tpu_torch.detect.render import example_frame, render_tag_in_scene
from repas_tpu_torch.detect.robust import detect_tags_robust_staged
from repas_tpu_torch.pipeline import process_frames_jit
from repas_tpu_torch.pose.pnp import solve_pnp_best_order

BATCH = 16
H, W = 720, 1280
ITERS = 10
CPU_BATCH = 2
CPU_ITERS = 2
CPU_MIN_S = 10.0
REF_PROBE_S = 10.0
DESIGN_FPS = 30.0
TAG_ID, TAG_Z, TAG_Z_TOL = 9, 0.45, 0.005       # the bench frame's tag
ROBUST_BATCH = 8
ROBUST_ITERS = 6
ROBUST_K = np.array([[912.35, 0, 628.78], [0, 911.78, 348.98], [0, 0, 1.0]],
                    np.float32)
REG_N = 1_000_000
REG_SEED = 7
REG_RV = (0.04, -0.06, 0.30)
REG_T = (0.06, -0.04, 0.05)
DEFAULT_BUDGET_S = 900.0
ROOT = Path(__file__).resolve().parents[1]      # the subprocesses' cwd


def _frames(batch):
    """The bench frame (tag 9 at 0.45 m) repeated `batch` times with
    integer noise in [-8, 8) from seed 0: (rgbs (B,H,W,3) uint8, depths
    (B,H,W) uint16, K (3,3) float32)."""
    rgb, depth, K = example_frame(H, W)
    rng = np.random.default_rng(0)
    rgbs = np.stack([rgb] * batch)
    rgbs = np.clip(rgbs.astype(np.int16)
                   + rng.integers(-8, 8, rgbs.shape), 0, 255).astype(np.uint8)
    depths = np.stack([depth] * batch)
    return rgbs, depths, K


def _gate(out):
    """Raises unless every frame's best slot (by margin) is tag 9 and the
    anchor's z is within 5 mm of 0.45 m: no rate for a broken pipeline."""
    det = out.detections
    best = torch.argmax(torch.where(det.valid, det.decision_margin, -1.0),
                        dim=1)
    rows = torch.arange(best.shape[0], device=best.device)
    ids = torch.where(det.valid[rows, best], det.ids[rows, best], -1).cpu()
    z = out.pose.anchor_P_depth[:, 2].cpu()
    if not (bool((ids == TAG_ID).all())
            and bool(((z - TAG_Z).abs() <= TAG_Z_TOL).all())):
        raise RuntimeError(f"the pipeline fails the bench gate: best ids "
                           f"{ids.tolist()}, anchor z {z.tolist()} m")


def _time_pipeline(batch, iters, min_s=0.0, device=None):
    """Frames/s of the compiled process_frames (process_frames_jit) on
    `batch` bench frames uploaded once to
    `device` (default CUDA): a gated warm call, then rounds of `iters`
    queued calls, each round ended by one host read, until `min_s`
    seconds have passed."""
    dev = host_data_device(device)
    rgbs, depths, K = _frames(batch)
    r = torch.from_numpy(rgbs).to(dev)
    d = torch.from_numpy(depths).to(dev)
    K = torch.from_numpy(K).to(dev)
    cfg = PipelineConfig()

    def sync(o):
        # a host read of late results drains the queue
        o.pose.anchor_P_depth.cpu()
        o.detections.ids.cpu()

    with torch.inference_mode():
        out = process_frames_jit(r, d, K, cfg)  # builds and captures
        _gate(out)
        t0 = time.perf_counter()
        n = 0
        while True:
            for _ in range(iters):
                out = process_frames_jit(r, d, K, cfg)
            sync(out)
            n += iters
            if time.perf_counter() - t0 >= min_s:
                break
        dt = time.perf_counter() - t0
    return batch * n / dt


def _rot(ax, ay, az):
    ax, ay, az = np.radians([ax, ay, az])
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    return rz @ ry @ rx


def robust_frames(seed: int = 0):
    """8 synthetic 1280x720 RGB frames, per-frame integer noise in
    [-8, 8) from `seed`: tags 9/16 of 61-87 px at assorted poses (0-3),
    38 px tags tilted 65 degrees that the decimated stage A cannot decode
    but the stage-B ROI pass does (4, 5), a gamma-darkened frame (f**3,
    6) and a textured frame without a tag (7). They stand in for
    bench.py's 8 real captures, which are not in the repository."""
    tag = PnPConfig().tag_size_m
    z_small = ROBUST_K[0, 0] * tag / 38.0
    poses = [(9, _rot(0, 0, 0), (-0.08, -0.04, 0.35)),
             (16, _rot(20, 0, 15), (0.1, 0.05, 0.40)),
             (9, _rot(-15, 10, -30), (0.12, -0.08, 0.45)),
             (16, _rot(15, 20, -10), (-0.12, 0.08, 0.45)),
             (9, _rot(65, 0, 10), (0.02, 0.01, z_small)),
             (16, _rot(65, 0, 10), (0.02, 0.01, z_small)),
             (16, _rot(10, -10, 5), (0.02, 0.03, 0.4))]
    imgs = [render_tag_in_scene(tid, R, np.asarray(t), ROBUST_K, tag, (H, W),
                                background=180.0) for tid, R, t in poses]
    imgs[6] = 255.0 * (imgs[6] / 255.0) ** 3
    y, x = np.mgrid[0:H, 0:W]
    imgs.append(140 + 50 * np.sin(x / 37.0) * np.cos(y / 53.0)
                + 20 * np.sin((x + 2 * y) / 11.0))
    rng = np.random.default_rng(seed)
    f = np.stack(imgs) + rng.integers(-8, 8, (ROBUST_BATCH, H, W))
    return np.repeat(np.clip(f, 0, 255)[..., None], 3, axis=-1).astype(
        np.uint8)


@functools.partial(jit, static_argnames=("tag_size",))
def pose_batch(det, K, tag_size):
    """bench.py's ``pose_batch``: best-order PnP on each frame's best slot
    by margin. Returns (best slot (B,), t (B,3), err (B,))."""
    best = torch.argmax(torch.where(det.valid, det.decision_margin, -1.0),
                        dim=1)
    rows = torch.arange(best.shape[0], device=best.device)
    _, t, err, _ = solve_pnp_best_order(det.corners[rows, best], K,
                                        tag_size)
    return best, t, err


def ladder_and_pose(frames, K, cfg, tag):
    """The robust workload (bench.py's ``run``): the staged ladder, then
    ``pose_batch``, each of its steps compiled. Returns (Detections,
    best slot (B,), t (B,3), err (B,))."""
    det = detect_tags_robust_staged(frames, cfg)
    return (det, *pose_batch(det, K, tag))


def _time_robust_ladder(device=None):
    """(frames/s, valid best slots) of the ladder + PnP on robust_frames()
    uploaded once: a warm call, 6 queued calls, one host read."""
    dev = host_data_device(device)
    frames = torch.from_numpy(robust_frames()).to(dev)
    K = torch.from_numpy(ROBUST_K).to(dev)
    cfg = DetectorConfig()
    tag = PnPConfig().tag_size_m
    with torch.inference_mode():
        det, best, t, _ = ladder_and_pose(frames, K, cfg, tag)
        t.cpu()
        rows = torch.arange(frames.shape[0], device=dev)
        n_found = int(det.valid[rows, best].sum())
        t0 = time.perf_counter()
        for _ in range(ROBUST_ITERS):
            _, _, t, _ = ladder_and_pose(frames, K, cfg, tag)
        t.cpu()
        dt = time.perf_counter() - t0
    return frames.shape[0] * ROBUST_ITERS / dt, n_found


def rotation(rvec):
    """The (3,3) float32 numpy rotation of a rotation vector."""
    return rodrigues(torch.tensor(rvec, dtype=torch.float32)).numpy()


def bumpy_scene(n: int, seed: int = REG_SEED):
    """bench.py's registration scene: n target points of the surface
    z = 0.08 sin(7x) cos(5y) + 0.05 x^2 over [-0.5, 0.5]^2, and the
    source that (R, t) maps onto them. Returns (src, tgt, R, t)."""
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(-0.5, 0.5, n),
                           rng.uniform(-0.5, 0.5, n),
                           np.zeros(n)]).astype(np.float32)
    pts[:, 2] = (0.08 * np.sin(7 * pts[:, 0]) * np.cos(5 * pts[:, 1])
                 + 0.05 * pts[:, 0] ** 2)
    R = rotation(REG_RV)
    t = np.array(REG_T, np.float32)
    return ((pts - t) @ R).astype(np.float32), pts, R, t


def _time_registration_1m(device=None):
    """(wall seconds, status) of register_clouds on the 1M scene: a warm
    run gated on fitness >= 0.3 and t error <= 0.02 m (else no time and a
    low_fitness status), then one timed run ended by a host read."""
    dev = host_data_device(device)
    src_np, tgt_np, _, t_true = bumpy_scene(REG_N)
    src = torch.from_numpy(src_np).to(dev)
    tgt = torch.from_numpy(tgt_np).to(dev)
    mask = torch.ones(REG_N, dtype=torch.bool, device=dev)

    def run():
        res, fit_g, _ = register_clouds(src, mask, tgt, mask, seed=REG_SEED)
        return res, fit_g, res.T.cpu().numpy()

    with torch.inference_mode():
        res, fit_g, T = run()
        err_t = float(np.linalg.norm(T[:3, 3] - t_true))
        fitness = float(res.fitness)
        if fitness < 0.3 or err_t > 0.02:
            return None, (f"low_fitness={fitness:.3f}_terr={err_t:.4f}"
                          f"_ransac={fit_g:.3f}")
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0, "ok"


def _cpu_probe():
    """The headline loop on this host's CPU, printed as one JSON line."""
    fps = _time_pipeline(CPU_BATCH, CPU_ITERS, min_s=CPU_MIN_S, device="cpu")
    print(json.dumps({"cpu_fps": fps}), flush=True)


def _ref_stack_probe():
    """The reference's own CPU stack on the bench frames: cv2.aruco
    AprilTag36h11 detection, solvePnP (IPPE_SQUARE) and a full-frame
    numpy deprojection, for REF_PROBE_S seconds; one JSON line."""
    import cv2

    rgbs, depths, K = _frames(8)
    half = 0.0303 / 2.0
    obj = np.array([[-half, -half, 0], [half, -half, 0],
                    [half, half, 0], [-half, half, 0]], np.float32)
    det = cv2.aruco.ArucoDetector(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))

    def one(rgb, depth):
        gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        corners, ids, _ = det.detectMarkers(gray)
        if ids is not None and len(ids):
            cv2.solvePnP(obj, corners[0][0], K.astype(np.float64), None,
                         flags=cv2.SOLVEPNP_IPPE_SQUARE)
        z = depth.astype(np.float32) / 1000.0
        return np.stack([(us - cx) * z / fx, (vs - cy) * z / fy, z], -1)

    one(rgbs[0], depths[0])
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < REF_PROBE_S:
        one(rgbs[n % len(rgbs)], depths[n % len(depths)])
        n += 1
    fps = n / (time.perf_counter() - t0)
    print(json.dumps({"ref_stack_cpu_fps": fps}), flush=True)


def _record(fps, cpu_fps, robust_fps, n_found, reg_1m_s=None, ref_fps=None,
            reg_1m_status=None, device=None):
    """bench.py's line: its keys in its order and rounding, but four."""
    return {
        "metric": "detect_pnp_pointcloud_720p",
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / cpu_fps, 2) if cpu_fps else None,
        "cpu_fps": round(cpu_fps, 3) if cpu_fps else None,
        # departure: nothing is cached, so a set cpu_fps is this run's
        "cpu_fps_cached": False if cpu_fps else None,
        "ref_stack_cpu_fps": round(ref_fps, 2) if ref_fps else None,
        "vs_ref_stack": round(fps / ref_fps, 2) if ref_fps else None,
        "vs_design_target": round(fps / DESIGN_FPS, 2),
        "mpts_per_s": round(fps * H * W / 1e6, 1),
        # departure: bench.py's real captures are not in the repository,
        # so the ladder's rate is the synthetic frames', under its own name
        "robust_real_fps": None,
        "robust_synth_fps": round(robust_fps, 2) if robust_fps else None,
        "robust_tags_found": n_found,
        # departure: bench.py:321 writes these wall seconds into
        # "registration_1m_pts_s"
        "registration_1m_wall_s": round(reg_1m_s, 2) if reg_1m_s else None,
        "registration_1m_status": reg_1m_status,
        # departure: the card that made every number of the line
        "device": device,
    }


def _device_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return dev.type
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def _probe(flag, key, timeout):
    """Runs this module with `flag` in a subprocess; returns the `key` of
    the JSON line it prints, or raises with its last line on stderr."""
    out = subprocess.run([sys.executable, "-m", "repas_tpu_torch.bench",
                          flag], capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)[key]
    err = out.stderr.strip().splitlines()
    raise RuntimeError(f"{flag} exited {out.returncode} without a line: "
                       f"{err[-1] if err else ''}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="The port's headline "
                                "benchmark (see the module docstring).")
    p.add_argument("--device", help="cuda (default) or cpu")
    p.add_argument("--cpu-probe", action="store_true",
                   help="print the CPU loop's frames/s and exit")
    p.add_argument("--ref-probe", action="store_true",
                   help="print the cv2 stack's frames/s and exit")
    args = p.parse_args(argv)
    if args.cpu_probe:
        _cpu_probe()
        return
    if args.ref_probe:
        _ref_stack_probe()
        return

    dev = host_data_device(args.device)
    budget = float(os.environ.get("REPAS_BENCH_BUDGET_S", DEFAULT_BUDGET_S))
    t_start = time.time()

    def remaining():
        return budget - (time.time() - t_start)

    device = _device_line(dev)
    # ---- headline first; its line survives any later overrun ----
    fps = _time_pipeline(BATCH, ITERS, device=dev)
    print(json.dumps(_record(fps, None, None, None, device=device)),
          flush=True)

    # ---- extras, each gated on the budget left, in bench.py's order.
    # Departure: no state file. bench.py reuses values of earlier runs
    # (and rotates the extras' order through it); here every field is
    # this run's or null, so a run of one commit never prints another's.
    res = {}

    def run_cpu():
        res["cpu_fps"] = _probe("--cpu-probe", "cpu_fps",
                                max(60, min(420, remaining() - 60)))

    def run_robust():
        res["robust_fps"], res["n_found"] = _time_robust_ladder(dev)

    def run_reg():
        res["reg_1m_s"], res["reg_1m_status"] = _time_registration_1m(dev)

    def run_ref_stack():
        res["ref_fps"] = _probe("--ref-probe", "ref_stack_cpu_fps",
                                max(60, min(180, remaining() - 30)))

    extras = [("cpu", 120, run_cpu), ("robust", 90, run_robust),
              ("reg1m", 240, run_reg), ("refstack", 45, run_ref_stack)]
    for name, min_s, fn in extras:
        if remaining() <= min_s:
            continue
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- recorded, not hidden
            traceback.print_exc()
            print(json.dumps({"extra_failed": name,
                              "exception": type(e).__name__,
                              "detail": str(e)[:200]}),
                  file=sys.stderr, flush=True)
            if name == "reg1m":
                res["reg_1m_status"] = f"exception={type(e).__name__}"
    # the final superset line (a reader of the last line gets it all)
    print(json.dumps(_record(fps, res.get("cpu_fps"), res.get("robust_fps"),
                             res.get("n_found"), res.get("reg_1m_s"),
                             res.get("ref_fps"), res.get("reg_1m_status"),
                             device)),
          flush=True)


if __name__ == "__main__":
    main()
