"""Headless point-cloud viewer (port of repas_tpu/apps/view_pointcloud.py)
— mirrors view_point_cloud.py / visualize_ply.py /
visualize_point_cloud.py: renders fixed orbit viewpoints of a PLY to
PNGs (no interactive GL in this environment).

  python -m repas_tpu_torch.apps.view_pointcloud scene.ply --out view
  python -m repas_tpu_torch.apps.view_pointcloud scene.ply --out view \
      --axes --max-dist 1.0
  python -m repas_tpu_torch.apps.view_pointcloud scene.ply --out view \
      --splat --orbit 8      # z-buffer splat renderer (viz.render) on
                             # --device (default cuda)
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import add_device_arg, log, to_device
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.image import write_image
from repas_tpu_torch.io.ply import read_ply
from repas_tpu_torch.viz.colormap import colorize_depth
from repas_tpu_torch.viz.html_viewer import write_html_viewer
from repas_tpu_torch.viz.render import orbit_views, render_pointcloud
from repas_tpu_torch.viz.scene import axes_points, plot_pointcloud


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", type=Path)
    p.add_argument("--out", type=Path, required=True,
                   help="output PNG prefix")
    p.add_argument("--axes", action="store_true")
    p.add_argument("--max-dist", type=float, default=0.0)
    p.add_argument("--max-points", type=int, default=100_000)
    p.add_argument("--splat", action="store_true",
                   help="render with the z-buffer splat renderer "
                        "(capture_aligned_all.py:127-186 equivalent) on "
                        "--device instead of matplotlib scatter")
    p.add_argument("--orbit", type=int, default=3,
                   help="number of orbit viewpoints (with --splat)")
    p.add_argument("--html", type=Path, default=None,
                   help="also write a self-contained INTERACTIVE WebGL "
                        "viewer (rotate/zoom/pan in any browser — the "
                        "headless equivalent of the reference's Open3D "
                        "draw_geometries window)")
    p.add_argument("--depth-preview", action="store_true",
                   help="color points by JET-colorized depth (distance "
                        "from camera, rs.colorizer semantics) instead of "
                        "their RGB — the bag_to_img.py:30-41 depth-stream "
                        "preview equivalent")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    pc = read_ply(args.input)
    pts = pc.points
    cols = pc.colors
    if args.max_dist > 0:
        m = np.linalg.norm(pts, axis=1) < args.max_dist
        pts = pts[m]
        cols = None if cols is None else cols[m]
    if args.depth_preview:
        cols = colorize_depth(np.linalg.norm(pts, axis=1)
                              ).astype(np.float32) / 255.0
    if args.html is not None:
        write_html_viewer(args.html, pts, cols, title=args.input.name)
        log.info("wrote interactive viewer %s", args.html)
    if args.splat:
        c = (np.full_like(pts, 0.5) if cols is None
             else np.asarray(cols, np.float32))
        xyzrgb = to_device(
            np.concatenate([pts, c], axis=1).astype(np.float32), dev)
        center = pts.mean(axis=0)
        radius = float(np.linalg.norm(pts - center, axis=1).max()) * 2.2
        K = np.array([[600.0, 0, 640], [0, 600.0, 360], [0, 0, 1]],
                     np.float32)
        paths = []
        for i, (R, t) in enumerate(orbit_views(center, radius,
                                               n=args.orbit)):
            img = render_pointcloud(xyzrgb, K, R, t,
                                    shape=(720, 1280)).cpu().numpy()
            out = Path(f"{args.out}_splat{i}.png")
            write_image(out, (np.clip(img, 0, 1) * 255).astype(np.uint8))
            paths.append(out)
        log.info("wrote %s", [str(x) for x in paths])
        return

    extra = axes_points(size=0.05) if args.axes else None
    paths = []
    for i, (elev, azim) in enumerate([(-70, -90), (-20, -45), (0, 0)]):
        out = Path(f"{args.out}_view{i}.png")
        plot_pointcloud(pts, cols, out, elev=elev, azim=azim,
                        max_points=args.max_points, extra_points=extra)
        paths.append(out)
    log.info("wrote %s", [str(x) for x in paths])


if __name__ == "__main__":
    main()
