"""Streaming multi-tag 6-DOF tracking over a replayed capture stream (port
of repas_tpu/apps/track_stream.py) — the BASELINE.json configs[2] shape
("streaming 30fps multi-tag 6DOF tracking") and the live-loop role of
better_three_capture.py / realtime_pose_estimation_april_tag.py, driven
by the replay backend.

Frames stream through the frame pipeline (process_frame: kernels B1, B2
and, with the cloud, B3), or through the robust ladder (--robust: B1,
B2 and the decimate-1 pass's B4), or the register-then-track streamer
(--temporal); per-frame fused poses are exported as JSONL and a rolling
FPS counter reports throughput.

  python -m repas_tpu_torch.apps.track_stream --source captures/ \
      --intrinsics K.json [--frames 100] [--loop] [--out poses.jsonl] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          frame0, log, resolve_intrinsics,
                                          to_device, to_host)
from repas_tpu_torch.core.config import PipelineConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.detect.robust import detect_tags_robust
from repas_tpu_torch.io.replay import ReplayBackend
from repas_tpu_torch.pipeline import process_frame
from repas_tpu_torch.pose.fusion import fuse_tag_poses_jit
from repas_tpu_torch.pose.track import TagTracker, TrackerConfig
from repas_tpu_torch.utils.profiling import FpsCounter


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", type=Path, required=True)
    add_intrinsics_args(p)
    p.add_argument("--frames", type=int, default=0, help="0 = one pass")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--tag-size", type=float, default=0.0303)
    p.add_argument("--out", type=Path, help="JSONL of per-frame poses")
    p.add_argument("--no-pointcloud", action="store_true")
    p.add_argument("--robust", action="store_true",
                   help="per-frame enhancement retry ladder (CLAHE/gamma, "
                        "the reference's recipe for hard frames); slower")
    p.add_argument("--temporal", action="store_true",
                   help="register-then-track with a pose prior: detect in "
                        "a small ROI around the predicted tag and GN-refine "
                        "the previous pose (run_custom.py:33-76 shape); "
                        "falls back to full detection on track loss")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    rb = ReplayBackend(args.source, loop=args.loop)
    if len(rb) == 0:
        raise SystemExit(f"no captures under {args.source}")

    cfg = PipelineConfig()
    fps = FpsCounter(tag="track")
    out_f = None
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        out_f = open(args.out, "w")

    tracker = None
    n = 0
    try:
        for frame in rb.frames():
            h, w = frame.color.shape[:2]
            intr = resolve_intrinsics(args, w, h)
            if args.temporal:
                if tracker is None:
                    tracker = TagTracker(
                        intr.K.astype(np.float32), tag_size=args.tag_size,
                        config=TrackerConfig(robust_register=args.robust),
                        device=dev)
                res = tracker.step(frame.color)
                rec = {
                    "frame": n, "timestamp": frame.timestamp,
                    "mode": res.mode, "ok": bool(res.ok),
                    "tag_id": int(res.tag_id),
                    "R": np.asarray(res.R).tolist(),
                    "t": np.asarray(res.t).tolist(),
                    "err_px": float(res.err_px),
                }
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                fps.tick()
                n += 1
                if args.frames and n >= args.frames:
                    break
                continue
            depth_m = frame.depth_meters()
            if depth_m is None:
                depth_u16 = np.zeros((h, w), np.uint16)
            else:
                if depth_m.shape != (h, w):
                    # depth saved at lower res: upsample nearest to color grid
                    ry = h // depth_m.shape[0]
                    rx = w // depth_m.shape[1]
                    depth_m = np.repeat(np.repeat(depth_m, ry, 0), rx, 1)[:h, :w]
                depth_u16 = np.clip(depth_m / cfg.depth.depth_scale, 0,
                                    65535).astype(np.uint16)
            K = to_device(intr.K.astype(np.float32), dev)
            rgb = to_device(frame.color, dev)
            if args.robust:
                det = detect_tags_robust(rgb, cfg.detector)
                # the reference passes zero coefficients: the PnP runs the
                # distortion path
                pose = frame0(fuse_tag_poses_jit(
                    *(x[None] for x in (det.corners, det.ids, det.areas,
                                        det.valid)),
                    to_device(depth_u16.astype(np.float32)
                              * cfg.depth.depth_scale, dev)[None], K,
                    args.tag_size, anchor_id=cfg.anchor_id,
                    dist=torch.zeros(8, device=dev)))
                det = to_host(det)
            else:
                res = process_frame(rgb, to_device(depth_u16, dev), K, cfg,
                                    with_pointcloud=not args.no_pointcloud)
                det, pose = to_host(res.detections), to_host(res.pose)
            rec = {
                "frame": n,
                "timestamp": frame.timestamp,
                "ids": det.ids[det.valid].tolist(),
                "R_avg": pose.R_avg.tolist(),
                "anchor_P_depth": pose.anchor_P_depth.tolist(),
                "margins": det.decision_margin[det.valid].tolist(),
            }
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
            fps.tick()
            n += 1
            if args.frames and n >= args.frames:
                break
    finally:
        if out_f:
            out_f.close()
    log.info("tracked %d frames (last fps %.1f)", n, fps.fps)


if __name__ == "__main__":
    main()
