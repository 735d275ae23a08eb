"""Aligned RGB-D capture via the replay backend (port of
repas_tpu/apps/capture_aligned.py) — mirrors the artifact contract of
better_three_capture.py:216-266: per frame write color PNG, aligned u16
depth PNG, depth-meters NPY, colored point-cloud PLY, and a capture
metadata JSON.

  python -m repas_tpu_torch.apps.capture_aligned --source capture_dir/ \
      --intrinsics K.json --out out_dir/ [--frames N] [--no-ply] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          log, to_device)
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.image import write_depth_png, write_image
from repas_tpu_torch.io.meta import timestamp, write_meta
from repas_tpu_torch.io.ply import PointCloud, write_ply
from repas_tpu_torch.io.replay import ReplayBackend
from repas_tpu_torch.kernels.pointcloud import rgbd_to_pointcloud
from repas_tpu_torch.viz.colormap import colorize_depth


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", type=Path, required=True,
                   help="replay directory of captures")
    add_intrinsics_args(p)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--frames", type=int, default=0, help="0 = all")
    p.add_argument("--no-ply", action="store_true")
    p.add_argument("--colorize", action="store_true",
                   help="also write a JET depth preview per frame "
                        "(depth_cm_<ts>.png — rs.colorizer semantics, "
                        "capture_aligned_all.py:81,206)")
    p.add_argument("--depth-scale", type=float, default=0.001)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    rb = ReplayBackend(args.source, intrinsics_json=args.intrinsics,
                       depth_scale=args.depth_scale)
    if len(rb) == 0:
        raise SystemExit(f"no captures found under {args.source}")

    n = 0
    for frame in rb.frames():
        ts = frame.timestamp or timestamp()
        out = args.out / f"capture_{ts}"
        out.mkdir(parents=True, exist_ok=True)
        write_image(out / f"color_{ts}.png", frame.color)
        depth_m = frame.depth_meters()
        files = {"color": f"color_{ts}.png"}
        if depth_m is not None:
            write_depth_png(out / f"aligned_depth_{ts}.png", depth_m,
                            args.depth_scale)
            np.save(out / f"aligned_depth_m_{ts}.npy", depth_m)
            files["depth_png"] = f"aligned_depth_{ts}.png"
            files["depth_npy"] = f"aligned_depth_m_{ts}.npy"
            if args.colorize:
                write_image(out / f"depth_cm_{ts}.png",
                            colorize_depth(depth_m))
                files["depth_preview"] = f"depth_cm_{ts}.png"
            if not args.no_ply:
                intr = (frame.color_intrinsics or
                        rb.intrinsics).scaled(depth_m.shape[1],
                                              depth_m.shape[0])
                color_small = frame.color
                if color_small.shape[:2] != depth_m.shape:
                    sy = color_small.shape[0] // depth_m.shape[0]
                    sx = color_small.shape[1] // depth_m.shape[1]
                    color_small = color_small[::sy, ::sx][
                        :depth_m.shape[0], :depth_m.shape[1]]
                pts, cols, valid = rgbd_to_pointcloud(
                    to_device(color_small, dev), to_device(depth_m, dev),
                    to_device(intr.K.astype(np.float32), dev))
                v = valid.cpu().numpy()
                write_ply(out / f"pointcloud_{ts}.ply",
                          PointCloud(points=pts.cpu().numpy()[v],
                                     colors=cols.cpu().numpy()[v]))
                files["ply"] = f"pointcloud_{ts}.ply"
        intr0 = frame.color_intrinsics
        write_meta(out / f"capture_meta_{ts}.json", "capture",
                   files=files, depth_scale=args.depth_scale,
                   frame_convention="camera: x right, y down, z forward",
                   intrinsics=(intr0.to_dict() if intr0 else None),
                   source=args.source)
        log.info("captured %s", out)
        n += 1
        if args.frames and n >= args.frames:
            break
    log.info("wrote %d captures to %s", n, args.out)


if __name__ == "__main__":
    main()
