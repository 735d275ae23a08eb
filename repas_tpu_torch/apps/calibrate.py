"""Checkerboard calibration from captured images (port of
repas_tpu/apps/calibrate.py): a directory of board views.

  python -m repas_tpu_torch.apps.calibrate --images dir/ --cols 19 \
      --rows 19 --square-mm 12.7 --out calib.json [--npz calib.npz] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.apps._common import add_device_arg, log
from repas_tpu_torch.calib import (calibrate_camera,
                                   detect_checkerboard_corners,
                                   refine_corners_subpix)
from repas_tpu_torch.core.calib import Intrinsics, save_intrinsics_json
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.image import read_image
from repas_tpu_torch.kernels.image import rgb_to_gray


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", type=Path, required=True)
    p.add_argument("--cols", type=int, default=19)
    p.add_argument("--rows", type=int, default=19)
    p.add_argument("--square-mm", type=float, default=12.7)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--npz", type=Path)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    paths = sorted(list(args.images.glob("*.png"))
                   + list(args.images.glob("*.jpg")))
    if len(paths) < 3:
        raise SystemExit(f"need >= 3 board views, found {len(paths)}")

    sq = args.square_mm / 1000.0
    xx, yy = np.meshgrid(np.arange(args.cols), np.arange(args.rows))
    obj = np.column_stack([xx.reshape(-1) * sq, yy.reshape(-1) * sq,
                           np.zeros(args.cols * args.rows)]).astype(np.float32)

    objs, imgs = [], []
    size = None
    for path in paths:
        img = torch.from_numpy(np.ascontiguousarray(read_image(path))).to(dev)
        gray = (img.to(torch.float32) if img.ndim == 2
                else rgb_to_gray(img))
        size = (gray.shape[1], gray.shape[0])
        corners, ok = detect_checkerboard_corners(gray, args.cols, args.rows)
        if not bool(ok):
            log.warning("%s: board not found, skipping", path.name)
            continue
        corners = refine_corners_subpix(gray, corners)
        objs.append(obj)
        imgs.append(corners.cpu().numpy())
        log.info("%s: %d corners", path.name, len(obj))

    if len(objs) < 3:
        raise SystemExit(f"only {len(objs)} usable views")

    K, dist, rms, rv, tv = calibrate_camera(np.stack(objs), np.stack(imgs),
                                            size, device=dev)
    log.info("RMS reprojection error: %.4f px", rms)
    log.info("K:\n%s", K)

    intr = Intrinsics(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                      width=size[0], height=size[1], dist=dist[:5])
    save_intrinsics_json(intr, args.out, "lean", extra={
        "dist_coeffs": dist[:5].tolist(),
        "checkerboard_inner_corners": {"cols": args.cols, "rows": args.rows},
        "square_size_mm": args.square_mm,
        "rms_px": rms,
    })
    if args.npz:
        np.savez(args.npz, K=K, dist=dist[:5][None], image_size=size,
                 checkerboard=[args.cols, args.rows],
                 square_size_mm=args.square_mm, rms=rms)
    log.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
