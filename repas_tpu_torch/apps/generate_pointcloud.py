"""RGB-D -> colored point-cloud PLY (port of
repas_tpu/apps/generate_pointcloud.py).

  python -m repas_tpu_torch.apps.generate_pointcloud --color c.png \
      --depth d.png --intrinsics K.json --out cloud.ply [--mask m.png] \
      [--voxel 0.005] [--max-dist 1.0] [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          load_depth_m, load_rgb, log,
                                          resolve_intrinsics)
from repas_tpu_torch.cloud import create_masked_pointcloud, radius_mask
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.image import read_image
from repas_tpu_torch.io.meta import write_meta
from repas_tpu_torch.io.ply import PointCloud, write_ply


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color", type=Path, required=True)
    p.add_argument("--depth", type=Path, required=True)
    p.add_argument("--mask", type=Path)
    add_intrinsics_args(p)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--voxel", type=float, default=0.0)
    p.add_argument("--outlier-nb", type=int, default=0)
    p.add_argument("--max-dist", type=float, default=0.0,
                   help="radial distance mask in meters (0 = off; "
                        "distance_masking_on_ply.py semantics)")
    p.add_argument("--normals", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    rgb = load_rgb(args.color)
    depth = load_depth_m(args.depth)
    h, w = depth.shape
    if rgb.shape[:2] != (h, w):
        rgb = rgb[::rgb.shape[0] // h, ::rgb.shape[1] // w][:h, :w]
    intr = resolve_intrinsics(args, w, h)
    mask = None
    if args.mask:
        m = (read_image(args.mask) > 0).astype(np.uint8)
        if m.ndim == 3:
            m = m[..., 0]
        mask = torch.from_numpy(np.ascontiguousarray(m)).to(dev)

    out = create_masked_pointcloud(
        torch.from_numpy(np.ascontiguousarray(rgb)).to(dev),
        torch.from_numpy(depth).to(dev), intr.K.astype(np.float32),
        mask=mask, voxel=args.voxel, outlier_nb=args.outlier_nb,
        with_normals=args.normals)
    valid = out.valid
    if args.max_dist > 0:
        valid = radius_mask(out.points, valid, args.max_dist)
    valid = valid.cpu().numpy()

    pc = PointCloud(points=out.points.cpu().numpy()[valid],
                    colors=out.colors.cpu().numpy()[valid],
                    normals=(out.normals.cpu().numpy()[valid]
                             if args.normals else None))
    write_ply(args.out, pc)
    write_meta(args.out.with_suffix(".meta.json"), "capture",
               source_color=args.color, source_depth=args.depth,
               intrinsics=intr.to_dict(), n_points=int(valid.sum()),
               voxel=args.voxel, max_dist=args.max_dist)
    log.info("wrote %s (%d points)", args.out, int(valid.sum()))


if __name__ == "__main__":
    main()
