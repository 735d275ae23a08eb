"""Multi-tag 6-DOF pose estimation + fusion (port of
repas_tpu/apps/estimate_pose.py) — mirrors the mpa_* pipeline
(mpa_final_view_with_export.py): detect, per-tag PnP, depth-corrected
translation, weighted rotation averaging, anchor select; or, with
--layout, one multi-tag SQPnP bundle solve for the camera pose.

  python -m repas_tpu_torch.apps.estimate_pose --color c.png --depth d.png \
      --intrinsics K.json [--tag-size 0.0303] [--tag-ids 9 16]
      [--anchor-id 16] [--layout layout.json] [--json out.json]
      [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          emit_json, frame0, load_depth_m,
                                          load_rgb, log, resolve_intrinsics,
                                          to_device)
from repas_tpu_torch.core.config import DetectorConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.detect import detect_tags_jit
from repas_tpu_torch.pose.bundle import solve_tag_bundle_jit
from repas_tpu_torch.pose.fusion import fuse_tag_poses_jit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color", type=Path, required=True)
    p.add_argument("--depth", type=Path, help="aligned depth png/npy")
    add_intrinsics_args(p)
    p.add_argument("--tag-size", type=float, default=0.0303)
    p.add_argument("--tag-ids", type=int, nargs="*", default=[9, 16])
    p.add_argument("--anchor-id", type=int, default=16)
    p.add_argument("--flip-z-ids", type=int, nargs="*", default=[9])
    p.add_argument("--layout", type=Path,
                   help="known world layout JSON {tag_id: [x,y,z]} -> one "
                        "multi-tag SQPnP bundle solve for the camera pose "
                        "(mpe_final_view_tag_bundle_with_cad.py TAG_3D_"
                        "POSITIONS semantics)")
    p.add_argument("--json", type=Path)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    rgb = load_rgb(args.color)
    h, w = rgb.shape[:2]
    intr = resolve_intrinsics(args, w, h)
    depth = (load_depth_m(args.depth) if args.depth
             else np.zeros((h, w), np.float32))
    if depth.shape != (h, w):
        raise SystemExit(
            f"Depth size mismatch: COLOR {w}x{h} vs DEPTH "
            f"{depth.shape[1]}x{depth.shape[0]}")

    det = detect_tags_jit(to_device(rgb, dev)[None], DetectorConfig())
    hdet = frame0(det)
    ids = hdet.ids
    valid = hdet.valid
    if args.tag_ids:
        valid = valid & np.isin(ids, args.tag_ids)
    if not valid.any():
        raise SystemExit(
            f"No requested tags {args.tag_ids} found. "
            f"Detected: {ids[hdet.valid].tolist()}")
    K = to_device(intr.K.astype(np.float32), dev)
    dist = to_device(np.asarray(intr.dist, np.float32), dev)

    if args.layout:
        layout = {int(k): v for k, v in
                  json.loads(args.layout.read_text()).items()}
        n = len(ids)
        centers_w = np.zeros((n, 3), np.float32)
        bundle_valid = np.zeros(n, bool)
        for i in range(n):
            if valid[i] and int(ids[i]) in layout:
                centers_w[i] = layout[int(ids[i])]
                bundle_valid[i] = True
        if not bundle_valid.any():
            raise SystemExit(f"no detected tags in layout {sorted(layout)}")
        R, t, err = solve_tag_bundle_jit(
            det.corners[0], det.centers[0], to_device(bundle_valid, dev),
            to_device(centers_w, dev), args.tag_size, K, dist)
        out = {
            "mode": "bundle",
            "tags_used": [int(i) for i in ids[bundle_valid]],
            "R_world_to_camera": R.cpu().numpy().tolist(),
            "t_world_to_camera": t.cpu().numpy().tolist(),
            "reproj_err_px": float(err),
        }
        log.info("bundle solve over %d tags: reproj %.3f px",
                 int(bundle_valid.sum()), float(err))
        emit_json(out, args.json)
        return out

    fused = frame0(fuse_tag_poses_jit(
        det.corners, det.ids, det.areas, to_device(valid, dev)[None],
        to_device(depth, dev)[None], K, args.tag_size,
        anchor_id=args.anchor_id, flip_z_ids=tuple(args.flip_z_ids or [-1]),
        dist=dist))

    out = {
        "tags": [
            {
                "id": int(ids[i]),
                "R": fused.R[i].tolist(),
                "t": fused.t[i].tolist(),
                "P_depth": fused.P_depth[i].tolist(),
                "P_depth_valid": bool(fused.P_depth_valid[i]),
                "reproj_err_px": float(fused.err_px[i]),
                "weight": float(fused.weights[i]),
            }
            for i in range(len(ids)) if valid[i]
        ],
        "R_avg": fused.R_avg.tolist(),
        "anchor_id": int(ids[int(fused.anchor_idx)]),
        "anchor_t": fused.anchor_t.tolist(),
        "anchor_P_depth": fused.anchor_P_depth.tolist(),
    }
    for tag in out["tags"]:
        log.info("id=%d reproj=%.2fpx weight=%.1f", tag["id"],
                 tag["reproj_err_px"], tag["weight"])
    emit_json(out, args.json)
    return out


if __name__ == "__main__":
    main()
