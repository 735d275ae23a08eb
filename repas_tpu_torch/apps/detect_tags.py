"""Detect tag36h11 tags in image(s) (port of repas_tpu/apps/detect_tags.py)
— mirrors april_tag_id_detector.py / april_tag_detector_img.py.

  python -m repas_tpu_torch.apps.detect_tags IMAGE [IMAGE...] \
      [--json OUT] [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repas_tpu_torch.apps._common import (add_device_arg, emit_json, frame0,
                                          load_rgb, log, to_device)
from repas_tpu_torch.core.config import DetectorConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.detect import detect_tags_jit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("images", nargs="+", type=Path)
    p.add_argument("--json", type=Path, help="write detections JSON here")
    p.add_argument("--min-margin", type=float, default=10.0)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    cfg = DetectorConfig(min_decision_margin=args.min_margin)
    results = []
    for path in args.images:
        img = load_rgb(path)
        det = frame0(detect_tags_jit(to_device(img, dev)[None], cfg))
        entry = {
            "image": str(path),
            "detections": [
                {
                    "id": int(det.ids[i]),
                    "corners": det.corners[i].tolist(),
                    "center": det.centers[i].tolist(),
                    "decision_margin": float(det.decision_margin[i]),
                    "hamming": int(det.hamming[i]),
                }
                for i in range(len(det.valid)) if det.valid[i]
            ],
        }
        log.info("%s: ids %s", path.name,
                 [d["id"] for d in entry["detections"]])
        results.append(entry)
    emit_json(results, args.json)
    return results


if __name__ == "__main__":
    main()
