"""Pack a recorded stream into a normalized replay directory (port of
repas_tpu/apps/pack_replay.py) — the offline record/replay conversion
tier of C27 (VERDICT r3 #8), mirroring bag_to_img.py:22-51 semantics
(open a recording, iterate frames, dump depth previews/images) without
the .bag container: here a "recording" is either an .npz stream (arrays
`color` (N,H,W,3) u8 and `depth` (N,H,W) u16 mm or f32 m, optional
`timestamps`) or any capture directory layout ReplayBackend recognizes.
Output is the canonical replay layout every repas app consumes
(rgb_<ts>.png + depth_raw_<ts>.png [+ meta JSON]). Its work is host I/O;
it takes --device as every port CLI does (default cuda, raising without
a card), and runs nothing there.

  python -m repas_tpu_torch.apps.pack_replay --input stream.npz --out dir/
  python -m repas_tpu_torch.apps.pack_replay --input messy_capture_dir/ \
      --out dir/ --colorize          # also write depth_cm_<ts>.png (JET)
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import (add_device_arg, add_intrinsics_args,
                                          log)
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.image import write_depth_png, write_image
from repas_tpu_torch.io.meta import timestamp, write_meta
from repas_tpu_torch.io.replay import Frame, ReplayBackend
from repas_tpu_torch.viz.colormap import colorize_depth


def _npz_frames(path: Path, depth_scale: float):
    """Yield Frames from an .npz stream recording."""
    z = np.load(path)
    color = z["color"]
    depth = z.get("depth")
    stamps = z.get("timestamps")
    for i in range(color.shape[0]):
        d = depth[i] if depth is not None else None
        raw = m = None
        if d is not None:
            if np.issubdtype(d.dtype, np.floating):
                m = d.astype(np.float32)
                raw = np.round(m / depth_scale).astype(np.uint16)
            else:
                raw = d.astype(np.uint16)
        ts = (str(stamps[i]) if stamps is not None
              else f"{timestamp()}_{i:06d}")
        yield Frame(color=np.asarray(color[i], np.uint8), depth_raw=raw,
                    depth_m=m, depth_scale=depth_scale, timestamp=ts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", type=Path, required=True,
                   help=".npz stream recording or a capture directory")
    p.add_argument("--out", type=Path, required=True)
    add_intrinsics_args(p)
    p.add_argument("--depth-scale", type=float, default=0.001)
    p.add_argument("--frames", type=int, default=0, help="0 = all")
    p.add_argument("--colorize", action="store_true",
                   help="also write JET depth previews (depth_cm_<ts>.png, "
                        "rs.colorizer semantics)")
    add_device_arg(p)
    args = p.parse_args(argv)
    host_data_device(args.device)

    if args.input.is_dir():
        rb = ReplayBackend(args.input, intrinsics_json=args.intrinsics,
                           depth_scale=args.depth_scale)
        if len(rb) == 0:
            raise SystemExit(f"no captures found under {args.input}")
        frames = rb.frames()
    elif args.input.suffix == ".npz":
        frames = _npz_frames(args.input, args.depth_scale)
    else:
        raise SystemExit(f"unsupported input {args.input} (dir or .npz; "
                         ".bag requires the camera SDK host tier)")

    args.out.mkdir(parents=True, exist_ok=True)
    n = 0
    names = []
    for frame in frames:
        ts = frame.timestamp or f"{timestamp()}_{n:06d}"
        write_image(args.out / f"rgb_{ts}.png", frame.color)
        names.append(f"rgb_{ts}.png")
        depth_m = frame.depth_meters()
        if frame.depth_raw is not None:
            write_image(args.out / f"depth_raw_{ts}.png", frame.depth_raw)
        elif depth_m is not None:
            write_depth_png(args.out / f"depth_raw_{ts}.png", depth_m,
                            args.depth_scale)
        if args.colorize and depth_m is not None:
            write_image(args.out / f"depth_cm_{ts}.png",
                        colorize_depth(depth_m))
        n += 1
        if args.frames and n >= args.frames:
            break
    write_meta(args.out / "replay_meta.json", "replay_pack",
               source=args.input, frames=n, depth_scale=args.depth_scale,
               layout="rgb_<ts>.png + depth_raw_<ts>.png (u16 mm)")
    log.info("packed %d frames into %s", n, args.out)


if __name__ == "__main__":
    main()
