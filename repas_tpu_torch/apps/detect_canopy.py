"""Plant-canopy height measurement (port of repas_tpu/apps/detect_canopy.py):
bar detection, segmentation, height.

  python -m repas_tpu_torch.apps.detect_canopy --color c.png --depth d.png \
      --intrinsics K.json [--out-txt camera_z.txt] [--viz out.png] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.apps._common import (add_device_arg,
                                          add_intrinsics_args, emit_json,
                                          load_depth_m, load_rgb, log,
                                          resolve_intrinsics)
from repas_tpu_torch.canopy import measure_plant_height
from repas_tpu_torch.core.config import CanopyConfig
from repas_tpu_torch.core.device import host_data_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color", type=Path, required=True)
    p.add_argument("--depth", type=Path, required=True)
    add_intrinsics_args(p)
    p.add_argument("--out-txt", type=Path,
                   help="write plant height like camera_z.txt")
    p.add_argument("--json", type=Path)
    p.add_argument("--viz", type=Path, help="annotated PNG output")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    rgb = load_rgb(args.color)
    depth = load_depth_m(args.depth)
    h, w = depth.shape
    intr = resolve_intrinsics(args, w, h)

    res = measure_plant_height(
        torch.from_numpy(np.ascontiguousarray(rgb)).to(dev),
        torch.from_numpy(depth).to(dev),
        torch.from_numpy(intr.K.astype(np.float32)).to(dev), CanopyConfig())
    res = type(res)(*(t.cpu() for t in res))
    if not bool(res.found):
        raise SystemExit("canopy measurement failed (no bar/plant/depth)")

    height = float(res.plant_height_m)
    out = {
        "plant_height_m": height,
        "canopy_3d": res.canopy_3d.numpy(),
        "bar_3d": res.bar_3d.numpy(),
        "canopy_px": res.canopy_px.numpy(),
        "bar_px": res.bar_px.numpy(),
        "rotation_deg": float(res.rotation_deg),
    }
    log.info("plant height: %.4f m (%.1f cm)", height, height * 100)
    if args.out_txt:
        args.out_txt.parent.mkdir(parents=True, exist_ok=True)
        args.out_txt.write_text(f"{height:.4f}")
    if args.viz:
        _draw_viz(rgb, res, args.viz)
    emit_json(out, args.json)
    return out


def _draw_viz(rgb, res, path):
    """Annotated measurement image via matplotlib (imported here only: the
    CLI runs without it when no --viz is asked for)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(rgb)
    cx, cy = np.asarray(res.canopy_px)
    bx, by = np.asarray(res.bar_px)
    ax.axhline(cy, color="red", lw=2)
    ax.axhline(by, color="lime", lw=2)
    ax.plot([cx], [cy], "o", color="blue", ms=8)
    ax.plot([bx], [by], "o", color="lime", ms=8)
    mid_x = (cx + bx) / 2
    ax.annotate("", xy=(mid_x, cy), xytext=(mid_x, by),
                arrowprops=dict(arrowstyle="<->", color="yellow", lw=2))
    h_cm = float(res.plant_height_m) * 100
    ax.set_title(f"PLANT HEIGHT: {h_cm:.1f} cm | canopy Y "
                 f"{float(res.canopy_3d[1]):.3f} m | bar Y "
                 f"{float(res.bar_3d[1]):.3f} m")
    ax.axis("off")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
