"""CAD placement at the fused tag pose (port of
repas_tpu/apps/place_cad.py): estimate pose, place CAD (scale -> rotate
about origin -> translate to anchor), optional ICP refinement against the
scene cloud, export transformed CAD + provenance.

  python -m repas_tpu_torch.apps.place_cad --color c.png --depth d.png \
      --intrinsics K.json --cad model.ply --out placed.ply [--icp] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          load_depth_m, load_rgb, log,
                                          resolve_intrinsics)
from repas_tpu_torch.apps.crop_scene import detect_and_fuse
from repas_tpu_torch.cloud import create_masked_pointcloud
from repas_tpu_torch.cloud.cad import (place_cad_at_anchor, refine_with_icp,
                                       transform_geometry)
from repas_tpu_torch.core.config import CadConfig, ICPConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.meta import write_meta
from repas_tpu_torch.io.ply import PointCloud, read_geometry, write_ply


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color", type=Path, required=True)
    p.add_argument("--depth", type=Path, required=True)
    add_intrinsics_args(p)
    p.add_argument("--cad", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--tag-size", type=float, default=0.0293,
                   help="mpa scripts use 0.0293 (mpa_icp_export.py:24)")
    p.add_argument("--tag-ids", type=int, nargs="*", default=[9, 16])
    p.add_argument("--anchor-id", type=int, default=16)
    p.add_argument("--cad-units-to-m", type=float, default=0.001)
    p.add_argument("--pre-rot-zyx", type=float, nargs=3,
                   default=[0.0, 0.0, 0.0])
    p.add_argument("--icp", action="store_true",
                   help="refine with point-to-plane ICP vs the scene")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    rgb = load_rgb(args.color)
    depth = load_depth_m(args.depth)
    h, w = depth.shape
    intr = resolve_intrinsics(args, w, h)
    det, fused, valid, K, rgb_t, depth_t = detect_and_fuse(
        rgb, depth, intr, args.tag_ids, args.tag_size, args.anchor_id, dev)
    R_avg = fused.R_avg[0].cpu().numpy()
    anchor = fused.anchor_P_depth[0].cpu().numpy()
    log.info("R_avg:\n%s", R_avg)
    log.info("anchor P_depth: %s", anchor)

    cad = read_geometry(args.cad)
    ccfg = CadConfig(units_to_meters=args.cad_units_to_m,
                     pre_rot_deg_zyx=tuple(args.pre_rot_zyx))
    placement = place_cad_at_anchor(cad, R_avg, anchor, ccfg)

    icp_report = None
    if args.icp:
        scene = create_masked_pointcloud(rgb_t, depth_t, K, outlier_nb=0)
        v = scene.valid.cpu().numpy()
        scene_pc = PointCloud(points=scene.points.cpu().numpy()[v])
        placed = transform_geometry(cad, placement.T_cad_world)
        icp_report, T_icp = refine_with_icp(placed, scene_pc, ICPConfig(),
                                            device=dev)
        placement.record("icp_refinement", T_icp)
        log.info("ICP fitness=%.3f rmse=%.4f drot=%.2fdeg dt=%.1fmm",
                 icp_report["fitness"], icp_report["inlier_rmse"],
                 icp_report["delta_rotation_deg"],
                 icp_report["delta_translation_mm"])

    out_geom = transform_geometry(cad, placement.T_cad_world)
    write_ply(args.out, out_geom)
    write_meta(args.out.with_suffix(".meta.json"), "cad_transform",
               cad=args.cad, tag_size_m=args.tag_size,
               weights=fused.weights[0].cpu().numpy()[valid],
               icp=icp_report, **placement.provenance())
    log.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
