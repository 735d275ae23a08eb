"""Calibration fetch/convert utility (port of
repas_tpu/apps/fetch_intrinsics.py) — mirrors fetch_intrinsics.py /
fetch_factory_intrinsic.py / fetch_factory_extrinsic.py (C19). Without
camera hardware, this converts/bundles existing calibration files and
reports stream profiles from a replay source. Its work is host I/O;
it takes --device as every port CLI does (default cuda, raising without
a card), and runs nothing there.

  python -m repas_tpu_torch.apps.fetch_intrinsics --color color.json \
      [--depth depth.json] [--extrinsics d2c.json] --out bundle.json \
      [--device cuda]
  python -m repas_tpu_torch.apps.fetch_intrinsics --source capture_dir/ --list
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repas_tpu_torch.apps._common import add_device_arg, log
from repas_tpu_torch.core.calib import (load_extrinsics_json,
                                        load_intrinsics_json)
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.replay import ReplayBackend


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color", type=Path)
    p.add_argument("--depth", type=Path)
    p.add_argument("--extrinsics", type=Path)
    p.add_argument("--out", type=Path)
    p.add_argument("--source", type=Path, help="replay dir for --list")
    p.add_argument("--list", action="store_true",
                   help="list stream profiles (supported_stream_list.py)")
    add_device_arg(p)
    args = p.parse_args(argv)
    host_data_device(args.device)

    if args.list:
        if not args.source:
            raise SystemExit("--list requires --source")
        rb = ReplayBackend(args.source)
        for prof in rb.profiles():
            log.info("%s %dx%d @%d %s", prof.stream, prof.width,
                     prof.height, prof.fps, prof.fmt)
        if not rb.profiles():
            log.warning("no streams found under %s", args.source)
        return

    if not (args.color and args.out):
        raise SystemExit("provide --color and --out (or --list)")
    bundle = {"color_intrinsics": load_intrinsics_json(args.color).to_dict()}
    if args.depth:
        bundle["depth_intrinsics"] = load_intrinsics_json(args.depth).to_dict()
    if args.extrinsics:
        e = load_extrinsics_json(args.extrinsics)
        bundle["extrinsics"] = {"depth_to_color": {"R": e.R.tolist(),
                                                   "t": e.t.tolist()}}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(bundle, indent=2))
    log.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
