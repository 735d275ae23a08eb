"""Apply a 4x4 pose txt to a CAD model (port of
repas_tpu/apps/apply_6dof.py; FoundationPose ob_in_cam ingestion).

  python -m repas_tpu_torch.apps.apply_6dof --pose pose.txt --cad model.ply \
      --out posed.ply [--units 0.001] [--icp --scene scene.ply] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import add_device_arg, log
from repas_tpu_torch.cloud.cad import apply_pose_txt, refine_with_icp
from repas_tpu_torch.core.config import ICPConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.meta import write_meta
from repas_tpu_torch.io.ply import read_geometry, read_ply, write_ply
from repas_tpu_torch.io.pose_txt import load_transform_txt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pose", type=Path, required=True)
    p.add_argument("--cad", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--units", type=float, default=0.001,
                   help="CAD units -> meters (export_6dof.py)")
    p.add_argument("--icp", action="store_true")
    p.add_argument("--scene", type=Path,
                   help="scene PLY for --icp refinement")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    T = load_transform_txt(args.pose)
    log.info("pose loaded, det(R)=%.6f", float(np.linalg.det(T[:3, :3])))
    cad = read_geometry(args.cad)
    posed, T_total = apply_pose_txt(cad, T, args.units)

    icp_report = None
    if args.icp:
        if not args.scene:
            raise SystemExit("--icp requires --scene")
        scene = read_ply(args.scene)
        icp_report, T_icp = refine_with_icp(posed, scene, ICPConfig(),
                                            device=dev)
        posed = posed.transformed(T_icp)
        T_total = T_icp @ T_total
        log.info("ICP fitness=%.3f rmse=%.4f", icp_report["fitness"],
                 icp_report["inlier_rmse"])

    write_ply(args.out, posed)
    write_meta(args.out.with_suffix(".meta.json"), "cad_transform",
               pose_txt=args.pose, cad=args.cad, units=args.units,
               T_total=T_total, icp=icp_report)
    log.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
