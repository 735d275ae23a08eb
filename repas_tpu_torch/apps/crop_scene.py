"""Tag-anchored scene crop (port of repas_tpu/apps/crop_scene.py): PnP
both tags with depth-corrected translation, build the tag-local box,
AABB-crop the cloud, export cropped PLY + provenance meta.

  python -m repas_tpu_torch.apps.crop_scene --color c.png --depth d.png \
      --intrinsics K.json --out cropped.ply --dx 0.1 0.1 --dy 0.1 0.1 \
      --dz 0.05 0.3 [--anchor-id 16] [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          load_depth_m, load_rgb, log,
                                          resolve_intrinsics)
from repas_tpu_torch.cloud import create_masked_pointcloud, tag_frame_aabb_crop
from repas_tpu_torch.core.config import CropConfig, DetectorConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.detect.detector import detect_tags_jit
from repas_tpu_torch.io.meta import write_meta
from repas_tpu_torch.io.ply import PointCloud, write_ply
from repas_tpu_torch.pose.fusion import fuse_tag_poses_jit


def detect_and_fuse(rgb, depth, intr, tag_ids, tag_size, anchor_id, dev):
    """The reference's single-frame detect -> fuse on the port's batched
    API (a batch of one). Returns (Detections, FusedPose, valid (N,) numpy,
    K (3,3) float32, rgb and depth tensors on `dev`); raises SystemExit
    when none of `tag_ids` is found."""
    K = intr.K.astype(np.float32)
    rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
    depth_t = torch.from_numpy(depth).to(dev)
    det = detect_tags_jit(rgb_t[None], DetectorConfig())
    valid = (det.valid[0].cpu().numpy()
             & np.isin(det.ids[0].cpu().numpy(), tag_ids))
    if not valid.any():
        raise SystemExit(f"no tags {tag_ids} found")
    # the reference always passes the coefficient vector (zeros for a lean
    # JSON), so its PnP runs the distortion path
    fused = fuse_tag_poses_jit(det.corners, det.ids, det.areas,
                               torch.from_numpy(valid[None]).to(dev),
                               depth_t[None], torch.from_numpy(K).to(dev),
                               tag_size, anchor_id=anchor_id,
                               dist=torch.from_numpy(
                                   intr.dist.astype(np.float32)).to(dev))
    return det, fused, valid, K, rgb_t, depth_t


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color", type=Path, required=True)
    p.add_argument("--depth", type=Path, required=True)
    add_intrinsics_args(p)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--tag-size", type=float, default=0.0303)
    p.add_argument("--tag-ids", type=int, nargs="*", default=[9, 16])
    p.add_argument("--anchor-id", type=int, default=16)
    p.add_argument("--dx", type=float, nargs=2, default=[0.1, 0.1],
                   metavar=("FRONT", "BACK"))
    p.add_argument("--dy", type=float, nargs=2, default=[0.1, 0.1])
    p.add_argument("--dz", type=float, nargs=2, default=[0.1, 0.1])
    p.add_argument("--pad", type=float, default=0.0)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    rgb = load_rgb(args.color)
    depth = load_depth_m(args.depth)
    h, w = depth.shape
    intr = resolve_intrinsics(args, w, h)
    det, fused, valid, K, rgb_t, depth_t = detect_and_fuse(
        rgb, depth, intr, args.tag_ids, args.tag_size, args.anchor_id, dev)

    cloud = create_masked_pointcloud(rgb_t, depth_t, K, outlier_nb=0)
    ccfg = CropConfig(dx_front=args.dx[0], dx_back=args.dx[1],
                      dy_front=args.dy[0], dy_back=args.dy[1],
                      dz_front=args.dz[0], dz_back=args.dz[1],
                      pad_m=args.pad, anchor_id=args.anchor_id)
    ai = int(fused.anchor_idx[0])
    mask, lo, hi, corners = tag_frame_aabb_crop(
        cloud.points, cloud.valid, fused.R[0, ai], fused.anchor_P_depth[0],
        ccfg)
    m = mask.cpu().numpy()
    pc = PointCloud(points=cloud.points.cpu().numpy()[m],
                    colors=cloud.colors.cpu().numpy()[m])
    write_ply(args.out, pc)
    write_meta(args.out.with_suffix(".meta.json"), "crop",
               intrinsics=intr.to_dict(),
               tag_ids=[int(i) for i in det.ids[0].cpu().numpy()[valid]],
               anchor_id=args.anchor_id,
               anchor_P_depth=fused.anchor_P_depth[0],
               R_anchor=fused.R[0, ai],
               aabb_lo=lo, aabb_hi=hi, box_corners_cam=corners,
               offsets={"dx": args.dx, "dy": args.dy, "dz": args.dz,
                        "pad": args.pad},
               n_points=int(m.sum()))
    log.info("cropped %d -> %d points -> %s",
             int(cloud.valid.sum()), int(m.sum()), args.out)


if __name__ == "__main__":
    main()
