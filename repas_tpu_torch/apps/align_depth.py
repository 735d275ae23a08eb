"""Depth -> color alignment (port of repas_tpu/apps/align_depth.py) — the
AlignFilter / rs.align role (N4/N5) as a standalone CLI: warp a depth
image from the depth camera's grid onto the color camera's grid using
factory intrinsics + d2c extrinsics.

  python -m repas_tpu_torch.apps.align_depth --depth d.png \
      --depth-intrinsics dK.json --color-intrinsics cK.json \
      --extrinsics d2c.json --width 1280 --height 720 --out aligned.png \
      [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import (add_device_arg, load_depth_m, log,
                                          to_device)
from repas_tpu_torch.core.calib import (load_extrinsics_json,
                                        load_intrinsics_json)
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.image import write_depth_png
from repas_tpu_torch.kernels.align import align_depth_to_color


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--depth", type=Path, required=True)
    p.add_argument("--depth-intrinsics", type=Path, required=True)
    p.add_argument("--color-intrinsics", type=Path, required=True)
    p.add_argument("--extrinsics", type=Path,
                   help="d2c extrinsics JSON (identity if omitted)")
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--no-fill", action="store_true",
                   help="skip 3x3 hole filling")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    depth_m = load_depth_m(args.depth)
    d_intr = load_intrinsics_json(args.depth_intrinsics, stream="depth")
    d_intr = d_intr.scaled(depth_m.shape[1], depth_m.shape[0])
    c_intr = load_intrinsics_json(args.color_intrinsics)
    c_intr = c_intr.scaled(args.width, args.height)
    if args.extrinsics:
        ext = load_extrinsics_json(args.extrinsics)
        R, t = ext.R, ext.t
    else:
        R, t = np.eye(3), np.zeros(3)

    aligned = align_depth_to_color(
        to_device(depth_m, dev), d_intr.K.astype(np.float32),
        c_intr.K.astype(np.float32), R.astype(np.float32),
        t.astype(np.float32), out_shape=(args.height, args.width),
        fill_holes=not args.no_fill)
    aligned = aligned.cpu().numpy()
    write_depth_png(args.out, aligned)
    valid = aligned[aligned > 0]
    log.info("aligned %s -> %s (%d valid px, median %.3f m)", args.depth,
             args.out, valid.size,
             float(np.median(valid)) if valid.size else 0.0)


if __name__ == "__main__":
    main()
