"""Multi-view point-cloud fusion (port of repas_tpu/apps/fuse_views.py) —
the BASELINE.json configs[4] shape ("full dual-camera pipeline: pose +
multi-view point-cloud fusion + CAD alignment"). Each view's tag pose
(the robust ladder, whose decimate-1 pass runs kernel B4 at 720p)
anchors its cloud into the common tag/world frame; clouds concatenate
(on a mesh this is the parallel.fuse_views_allgather gather), optionally
followed by CAD placement + ICP against the fused scene.

  python -m repas_tpu_torch.apps.fuse_views --views dir1 dir2 ... \
      --intrinsics K.json --out fused.ply [--anchor-id 16]
      [--cad model.ply --cad-out placed.ply] [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          log, resolve_intrinsics, to_device)
from repas_tpu_torch.cloud import create_masked_pointcloud, voxel_downsample
from repas_tpu_torch.cloud.cad import (place_cad_at_anchor, refine_with_icp,
                                       transform_geometry)
from repas_tpu_torch.core.config import CadConfig, DetectorConfig, ICPConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.transforms import invert_T, make_T
from repas_tpu_torch.detect.robust import detect_tags_robust
from repas_tpu_torch.io.meta import write_meta
from repas_tpu_torch.io.ply import PointCloud, read_geometry, write_ply
from repas_tpu_torch.io.replay import ReplayBackend
from repas_tpu_torch.pose.fusion import fuse_tag_poses_jit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--views", type=Path, nargs="+", required=True,
                   help="capture dirs, one per camera/view")
    add_intrinsics_args(p)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--tag-size", type=float, default=0.0303)
    p.add_argument("--anchor-id", type=int, default=16)
    p.add_argument("--voxel", type=float, default=0.0,
                   help="fused-cloud voxel downsample")
    p.add_argument("--cad", type=Path)
    p.add_argument("--cad-out", type=Path)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    fused_pts, fused_cols = [], []
    view_meta = []
    for view in args.views:
        rb = ReplayBackend(view)
        if len(rb) == 0:
            log.warning("%s: no captures, skipping", view)
            continue
        # first frame that has a depth pair (capture dirs may hold extra
        # color-only frames)
        frame = next((f for f in rb.read_all()
                      if f.depth_meters() is not None), None)
        if frame is None:
            log.warning("%s: no depth, skipping", view)
            continue
        h, w = frame.color.shape[:2]
        intr = resolve_intrinsics(args, w, h)
        K = intr.K.astype(np.float32)
        depth_m = frame.depth_meters()
        if depth_m.shape != (h, w):
            ry, rx = h // depth_m.shape[0], w // depth_m.shape[1]
            depth_m = np.repeat(np.repeat(depth_m, ry, 0), rx, 1)[:h, :w]
        rgb_t, depth_t = to_device(frame.color, dev), to_device(depth_m, dev)
        det = detect_tags_robust(rgb_t, DetectorConfig())
        ids = det.ids.cpu().numpy()
        if not det.valid.cpu().numpy().any():
            log.warning("%s: no tags, skipping", view)
            continue
        fused = fuse_tag_poses_jit(
            *(x[None] for x in (det.corners, det.ids, det.areas, det.valid)),
            depth_t[None], to_device(K, dev), args.tag_size,
            anchor_id=args.anchor_id,
            dist=to_device(np.asarray(intr.dist, np.float32), dev))
        ai = int(fused.anchor_idx[0])
        # camera -> tag/world frame: T_wc = inv([R_anchor | P_depth])
        T_wc = invert_T(make_T(fused.R[0, ai], fused.anchor_P_depth[0])
                        ).cpu().numpy()

        cloud = create_masked_pointcloud(rgb_t, depth_t, K, outlier_nb=0)
        v = cloud.valid.cpu().numpy()
        pts = cloud.points.cpu().numpy()[v] @ T_wc[:3, :3].T + T_wc[:3, 3]
        fused_pts.append(pts)
        fused_cols.append(cloud.colors.cpu().numpy()[v])
        view_meta.append({"view": str(view), "n_points": int(v.sum()),
                          "anchor_id": int(ids[ai]),
                          "T_world_from_camera": T_wc.tolist()})
        log.info("%s: %d points into world frame (anchor id %d)",
                 view.name, int(v.sum()), int(ids[ai]))

    if not fused_pts:
        raise SystemExit("no views fused")
    pts = np.concatenate(fused_pts)
    cols = np.concatenate(fused_cols)
    if args.voxel > 0:
        P, C, _, valid = voxel_downsample(
            to_device(pts.astype(np.float32), dev),
            to_device(np.ones(len(pts), bool), dev), args.voxel,
            colors=to_device(cols.astype(np.float32), dev))
        m = valid.cpu().numpy()
        pts, cols = P.cpu().numpy()[m], C.cpu().numpy()[m]
    write_ply(args.out, PointCloud(points=pts, colors=cols))
    write_meta(args.out.with_suffix(".meta.json"), "capture",
               views=view_meta, n_points=len(pts), voxel=args.voxel,
               frame="tag-anchored world (anchor tag at origin)")
    log.info("fused %d views -> %d points -> %s", len(view_meta), len(pts),
             args.out)

    if args.cad:
        # CAD sits at the anchor tag origin in the world frame
        cad = read_geometry(args.cad)
        placement = place_cad_at_anchor(cad, np.eye(3), np.zeros(3),
                                        CadConfig())
        placed = transform_geometry(cad, placement.T_cad_world)
        rep, T_icp = refine_with_icp(placed, PointCloud(points=pts),
                                     ICPConfig(), device=dev)
        placement.record("icp_refinement", T_icp)
        out_geom = transform_geometry(cad, placement.T_cad_world)
        cad_out = args.cad_out or args.out.with_name("cad_" + args.out.name)
        write_ply(cad_out, out_geom)
        write_meta(cad_out.with_suffix(".meta.json"), "cad_transform",
                   icp=rep, **placement.provenance())
        log.info("CAD aligned to fused scene: fitness %.3f -> %s",
                 rep["fitness"], cad_out)


if __name__ == "__main__":
    main()
