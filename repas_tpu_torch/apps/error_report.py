"""Alignment error analysis (port of repas_tpu/apps/error_report.py).

  # picked-point correspondences (MeshLab .pp files)
  python -m repas_tpu_torch.apps.error_report corr --ref a.pp --meas b.pp \
      --txt errors.txt --csv errors.csv

  # point-to-surface distances (on --device, default cuda)
  python -m repas_tpu_torch.apps.error_report surface --cloud scene.ply \
      --mesh cad.stl --txt alignment_errors.txt --png error_histogram.png \
      [--colored-out colored.ply] [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.apps._common import add_device_arg, emit_json, log
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.eval.reports import (correspondence_report,
                                          error_colormap,
                                          load_picked_points,
                                          point_to_mesh_signed_distances,
                                          surface_error_report)
from repas_tpu_torch.io.ply import (PointCloud, read_geometry, read_ply,
                                    write_ply)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("corr")
    pc.add_argument("--ref", type=Path, required=True)
    pc.add_argument("--meas", type=Path, required=True)
    pc.add_argument("--txt", type=Path)
    pc.add_argument("--csv", type=Path)
    pc.add_argument("--json", type=Path)

    ps = sub.add_parser("surface")
    ps.add_argument("--cloud", type=Path, required=True)
    ps.add_argument("--mesh", type=Path, required=True)
    ps.add_argument("--txt", type=Path)
    ps.add_argument("--png", type=Path)
    ps.add_argument("--json", type=Path)
    ps.add_argument("--colored-out", type=Path,
                    help="write cloud colored by error (green->red)")
    ps.add_argument("--color-scale", type=Path,
                    help="write the colormap legend PNG (color_scale.png)")
    add_device_arg(ps)
    args = p.parse_args(argv)

    if args.cmd == "corr":
        ref = load_picked_points(args.ref)
        meas = load_picked_points(args.meas)
        rep = correspondence_report(ref, meas, txt_path=args.txt,
                                    csv_path=args.csv)
        log.info("mean %.2f mm rmse %.2f mm grade %s",
                 rep["mean_euclidean_mm"], rep["rmse_mm"],
                 rep["overall_grade"])
        emit_json(rep, args.json)
        return rep

    dev = host_data_device(args.device)
    cloud = read_ply(args.cloud)
    mesh = read_geometry(args.mesh)
    # signed (negative inside); stats/colors use the magnitude, the txt
    # report adds the signed bias / inside-outside split
    d = point_to_mesh_signed_distances(
        torch.as_tensor(np.asarray(cloud.points, np.float32), device=dev),
        torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=dev),
        torch.as_tensor(np.asarray(mesh.triangles, np.int32), device=dev)
    ).cpu().numpy()
    rep = surface_error_report(d, txt_path=args.txt, png_path=args.png)
    log.info("mean %.3f mm median %.3f mm rmse %.3f mm over %d points",
             rep["mean_mm"], rep["median_mm"], rep["rmse_mm"], rep["count"])
    if args.colored_out:
        write_ply(args.colored_out,
                  PointCloud(points=cloud.points, colors=error_colormap(d)))
    if args.color_scale:
        from repas_tpu_torch.viz.scene import save_color_scale
        save_color_scale(args.color_scale)
    emit_json(rep, args.json)
    return rep


if __name__ == "__main__":
    main()
