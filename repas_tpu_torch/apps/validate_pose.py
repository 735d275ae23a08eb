"""Pose validation harnesses (C25) (port of
repas_tpu/apps/validate_pose.py) — mirrors the testing_scripts:

  translation: N captures with known physical camera displacement; checks
    per-pair delta-tvec (three_pose_vertical_translation_validation.py:120-177)
  depth: PnP z vs point-cloud z at the projected tag center + scale factor
    (vis_tool_april_tag_pose_validaiton.py:166-274)
  threeway: detector pose vs PnP vs the raw depth point (final_view.py)
  manual: AprilTag placement vs a hand-measured 4x4
    (manual_pose_verify.py:42-56)

  python -m repas_tpu_torch.apps.validate_pose translation \
      --captures d1 d2 d3 --intrinsics K.json [--expected-delta 0 0.1 0]
  python -m repas_tpu_torch.apps.validate_pose depth --color c.png \
      --depth d.png --intrinsics K.json
  python -m repas_tpu_torch.apps.validate_pose manual --color c.png \
      --intrinsics K.json --pose manual.txt
(each with [--device cuda])
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          emit_json, frame0, load_depth_m,
                                          load_rgb, log, resolve_intrinsics,
                                          to_device)
from repas_tpu_torch.core.config import DetectorConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.transforms import rotation_angle_deg
from repas_tpu_torch.detect import detect_tags_jit
from repas_tpu_torch.io.pose_txt import load_transform_txt
from repas_tpu_torch.io.replay import ReplayBackend
from repas_tpu_torch.kernels.pointcloud import median_depth_window
from repas_tpu_torch.pose.depth_correct import z_scale_correction
from repas_tpu_torch.pose.pnp import detector_pose, solve_pnp_best_order_jit


def _best_tag_pose(rgb, intr, tag_size, dev, margin=10.0):
    det = detect_tags_jit(to_device(rgb, dev)[None], DetectorConfig())
    hdet = frame0(det)
    valid = hdet.valid & (hdet.decision_margin >= margin)
    if not valid.any():
        return None
    i = int(np.argmax(np.where(valid, hdet.decision_margin, -1)))
    R, t, err, order = solve_pnp_best_order_jit(
        det.corners[0, i], to_device(intr.K.astype(np.float32), dev),
        tag_size, dist=to_device(np.asarray(intr.dist, np.float32), dev))
    return {"id": int(hdet.ids[i]), "R": R.cpu().numpy(),
            "t": t.cpu().numpy(), "err_px": float(err),
            "corners": hdet.corners[i]}


def _median_depth(depth, u, v, dev) -> float:
    """median_depth_window at one pixel of one image."""
    return float(median_depth_window(
        to_device(depth, dev)[None], torch.tensor([[u]], device=dev),
        torch.tensor([[v]], device=dev), 5)[0, 0])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("translation")
    pt.add_argument("--captures", type=Path, nargs="+", required=True)
    add_intrinsics_args(pt)
    pt.add_argument("--tag-size", type=float, default=0.0303)
    pt.add_argument("--expected-delta", type=float, nargs=3)
    pt.add_argument("--json", type=Path)

    pd = sub.add_parser("depth")
    pd.add_argument("--color", type=Path, required=True)
    pd.add_argument("--depth", type=Path, required=True)
    add_intrinsics_args(pd)
    pd.add_argument("--tag-size", type=float, default=0.0303)
    pd.add_argument("--json", type=Path)

    pm = sub.add_parser("manual")
    pm.add_argument("--color", type=Path, required=True)
    add_intrinsics_args(pm)
    pm.add_argument("--pose", type=Path, required=True)
    pm.add_argument("--tag-size", type=float, default=0.0303)
    pm.add_argument("--json", type=Path)

    p3 = sub.add_parser(
        "threeway",
        help="detector-pose vs PnP vs raw-depth tag center in mm "
             "(final_view.py:305-365)")
    p3.add_argument("--color", type=Path, required=True)
    p3.add_argument("--depth", type=Path, required=True)
    add_intrinsics_args(p3)
    p3.add_argument("--tag-size", type=float, default=0.0303)
    p3.add_argument("--json", type=Path)
    for sp in (pt, pd, pm, p3):
        add_device_arg(sp)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    if args.cmd == "translation":
        poses = []
        for cap in args.captures:
            rb = ReplayBackend(cap)
            frame = rb.read_all()[0]
            intr = resolve_intrinsics(args, frame.color.shape[1],
                                      frame.color.shape[0])
            pose = _best_tag_pose(frame.color, intr, args.tag_size, dev)
            if pose is None:
                raise SystemExit(f"no tag in {cap}")
            poses.append(pose)
            log.info("%s: id=%d t=%s err=%.2fpx", cap.name, pose["id"],
                     pose["t"].round(4), pose["err_px"])
        out = {"poses": [{"t": p_["t"], "err_px": p_["err_px"]}
                         for p_ in poses], "deltas": []}
        for i in range(1, len(poses)):
            # camera moved; tag fixed -> delta of tag position in camera
            # frame = -camera displacement
            d = poses[i]["t"] - poses[i - 1]["t"]
            entry = {"pair": [i - 1, i], "delta_t": d,
                     "norm_mm": float(np.linalg.norm(d) * 1000)}
            if args.expected_delta:
                exp = np.asarray(args.expected_delta)
                entry["error_mm"] = float(np.linalg.norm(d - exp) * 1000)
            out["deltas"].append(entry)
            log.info("pose %d->%d: delta %s (%.1f mm)", i - 1, i,
                     d.round(4), entry["norm_mm"])
        emit_json(out, args.json)
        return out

    if args.cmd == "depth":
        rgb = load_rgb(args.color)
        depth = load_depth_m(args.depth)
        intr = resolve_intrinsics(args, rgb.shape[1], rgb.shape[0])
        pose = _best_tag_pose(rgb, intr, args.tag_size, dev)
        if pose is None:
            raise SystemExit("no tag detected")
        t = pose["t"]
        K = intr.K
        u = int(round(K[0, 0] * t[0] / t[2] + K[0, 2]))
        v = int(round(K[1, 1] * t[1] / t[2] + K[1, 2]))
        z_pcd = _median_depth(depth, u, v, dev)
        t_corr, s = z_scale_correction(to_device(t, dev), z_pcd)
        out = {"id": pose["id"], "pnp_z": float(t[2]), "pointcloud_z": z_pcd,
               "scale_factor": float(s),
               "t_corrected": t_corr.cpu().numpy(),
               "z_error_mm": float(abs(t[2] - z_pcd) * 1000)}
        log.info("PnP z=%.4f pcd z=%.4f scale=%.4f", t[2], z_pcd, float(s))
        emit_json(out, args.json)
        return out

    if args.cmd == "threeway":
        # three independent estimates of the tag position, in mm
        # (final_view.py:305-365: detector pose vs solvePnP vs the raw
        # depth point at the projected tag center)
        rgb = load_rgb(args.color)
        depth = load_depth_m(args.depth)
        intr = resolve_intrinsics(args, rgb.shape[1], rgb.shape[0])
        pose = _best_tag_pose(rgb, intr, args.tag_size, dev)
        if pose is None:
            raise SystemExit("no tag detected")
        t_pnp = pose["t"]
        Rd, t_det, err_det = detector_pose(
            to_device(pose["corners"], dev),
            to_device(intr.K.astype(np.float32), dev), args.tag_size)
        t_det = t_det.cpu().numpy()
        K = intr.K
        u = int(round(K[0, 0] * t_pnp[0] / t_pnp[2] + K[0, 2]))
        v = int(round(K[1, 1] * t_pnp[1] / t_pnp[2] + K[1, 2]))
        Kd = intr.scaled(depth.shape[1], depth.shape[0]).K
        ud = int(round(u * depth.shape[1] / rgb.shape[1]))
        vd = int(round(v * depth.shape[0] / rgb.shape[0]))
        z = _median_depth(depth, ud, vd, dev)
        t_depth = np.array([(ud - Kd[0, 2]) * z / Kd[0, 0],
                            (vd - Kd[1, 2]) * z / Kd[1, 1], z])
        out = {
            "id": pose["id"],
            "t_pnp_mm": t_pnp * 1000,
            "t_detector_mm": t_det * 1000,
            "t_depth_mm": t_depth * 1000,
            "pnp_vs_detector_mm": float(
                np.linalg.norm(t_pnp - t_det) * 1000),
            "pnp_vs_depth_mm": float(
                np.linalg.norm(t_pnp - t_depth) * 1000),
            "detector_vs_depth_mm": float(
                np.linalg.norm(t_det - t_depth) * 1000),
            "pnp_err_px": pose["err_px"],
            "detector_err_px": float(err_det),
        }
        log.info("PnP %s | detector %s | depth %s (mm)",
                 (t_pnp * 1000).round(1), (t_det * 1000).round(1),
                 (t_depth * 1000).round(1))
        log.info("deltas mm: pnp-det %.1f, pnp-depth %.1f, det-depth %.1f",
                 out["pnp_vs_detector_mm"], out["pnp_vs_depth_mm"],
                 out["detector_vs_depth_mm"])
        emit_json(out, args.json)
        return out

    # manual
    rgb = load_rgb(args.color)
    intr = resolve_intrinsics(args, rgb.shape[1], rgb.shape[0])
    pose = _best_tag_pose(rgb, intr, args.tag_size, dev)
    if pose is None:
        raise SystemExit("no tag detected")
    T = load_transform_txt(args.pose)
    dR = float(rotation_angle_deg(to_device(T[:3, :3].astype(np.float32),
                                            dev), to_device(pose["R"], dev)))
    dt = pose["t"] - T[:3, 3]
    out = {"id": pose["id"], "rotation_delta_deg": dR,
           "translation_delta_mm": (dt * 1000),
           "translation_delta_norm_mm": float(np.linalg.norm(dt) * 1000)}
    log.info("vs manual pose: drot=%.2f deg, dt=%.1f mm", dR,
             out["translation_delta_norm_mm"])
    emit_json(out, args.json)
    return out


if __name__ == "__main__":
    main()
