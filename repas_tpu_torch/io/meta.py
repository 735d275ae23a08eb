"""Sidecar metadata JSON — the pipeline's provenance / resume contract.

Port of ``repas_tpu/io/meta.py``: the same JSON, "generator":
"repas_tpu" included, so a sidecar chain can mix both packages; torch
tensors (on any device) are written as their values.

The reference chains its stages through disk: every producer writes a
metadata JSON next to its artifact and the next stage resumes from it
(SURVEY.md §5.4). Schemas mirrored here:

  * capture meta   (better_three_capture.py:244-259): profiles, depth scale,
                    frame convention, file names
  * crop meta      (april_tag_bg_removal_pl.py:554-601): intrinsics, AABB,
                    tag ids, transform order
  * CAD transform meta (mpa_icp_export.py:483-512): accumulated 4x4 pre/post
                    ICP, per-tag weights, ICP params
  * STL meta       (ply_to_stl.py:196-207)
"""
from __future__ import annotations

import datetime as _dt
import json
from pathlib import Path

import numpy as np


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if hasattr(obj, "detach"):  # torch tensors, on any device
        return _jsonable(obj.detach().cpu().numpy().tolist())
    if hasattr(obj, "tolist"):
        return _jsonable(np.asarray(obj).tolist())
    if isinstance(obj, Path):
        return str(obj)
    return obj


def write_meta(path, kind: str, **fields) -> dict:
    """Write a metadata sidecar. `kind` in {capture, crop, cad_transform,
    stl, calibration, canopy, error_report}."""
    meta = {
        "kind": kind,
        "generator": "repas_tpu",
        "timestamp": _dt.datetime.now().isoformat(timespec="seconds"),
    }
    meta.update(_jsonable(fields))
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(meta, indent=2))
    return meta


def read_meta(path) -> dict:
    return json.loads(Path(path).read_text())


def timestamp() -> str:
    """YYYY-MM-DDTHHMMSS, matching get_timestamp (canopy_return_upgraded.py:7-9)."""
    return _dt.datetime.now().strftime("%Y-%m-%dT%H%M%S")
