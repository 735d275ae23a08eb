"""Camera intrinsics / extrinsics schemas and loaders.

Port of ``repas_tpu/core/calib.py`` (host numpy, unchanged).

The reference ships calibration data in three JSON schemas plus NPZ:

  * "lean"     — {"fx","fy","cx","cy","width","height"}
                 (reference: femto_bolt_code/scripts/calibration_parameters/
                  factory_color_intrinsics_2025-09-08T143506.json; loader at
                  mpa_final_view_with_export.py:52-63)
  * "bundle"   — {"color_intrinsics": {...}, "depth_intrinsics": {...},
                  "extrinsics": {"depth_to_color": {...}}}
                 (reference: fetch_intrinsics.py:100-139)
  * "realsense"— {"fx","fy","ppx","ppy","width","height","coeffs",
                  "distortion_model"}
                 (reference: realsense_d415i/april_tag_detection_caliberation/
                  factory_color_intrinsics_640_480.json; loader at
                  vis_tool/vis_tool_april_tag_pose_validaiton.py:38-47)
  * checkerboard JSON — lean + {"dist_coeffs","checkerboard_inner_corners",
                  "square_size_mm","rms_px"}
                 (reference: checkerboard_callibration.py:241-255)
  * NPZ        — {"K","dist","image_size","checkerboard","square_size_mm","rms"}

Extrinsics come as {"R","t"} (femto d2c) or {"R_dc","t_dc"} (realsense,
fetch_factory_extrinsic.py:1-22).

All loaders here accept every schema and normalize into `Intrinsics` /
`Extrinsics` dataclasses. `Intrinsics` is a host-side container; the
device-side view is `K` (3x3 float array) + `dist` (length-8 Brown-Conrady
coefficient vector, zero-padded).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# Distortion coefficient layout (OpenCV Brown-Conrady order):
#   [k1, k2, p1, p2, k3, k4, k5, k6]
N_DIST = 8


def _pad_dist(coeffs: Optional[Sequence[float]]) -> np.ndarray:
    d = np.zeros((N_DIST,), dtype=np.float64)
    if coeffs is not None:
        c = np.asarray(coeffs, dtype=np.float64).reshape(-1)
        d[: min(len(c), N_DIST)] = c[:N_DIST]
    return d


@dataclass(frozen=True)
class Intrinsics:
    """Pinhole + Brown-Conrady camera model."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 0
    height: int = 0
    dist: np.ndarray = field(default_factory=lambda: np.zeros(N_DIST))
    model: str = "brown_conrady"

    def __post_init__(self):
        object.__setattr__(self, "dist", _pad_dist(self.dist))

    @property
    def K(self) -> np.ndarray:
        return build_K(self.fx, self.fy, self.cx, self.cy)

    def scaled(self, dst_w: int, dst_h: int) -> "Intrinsics":
        """Rescale to a different image resolution.

        Matches scale_intrinsics at mpa_final_view_with_export.py:65-69:
        no-op when source size is unknown or equal.
        """
        if self.width <= 0 or self.height <= 0 or (
            self.width == dst_w and self.height == dst_h
        ):
            return replace(self, width=dst_w or self.width,
                           height=dst_h or self.height)
        sx = float(dst_w) / float(self.width)
        sy = float(dst_h) / float(self.height)
        return replace(
            self, fx=self.fx * sx, fy=self.fy * sy,
            cx=self.cx * sx, cy=self.cy * sy, width=dst_w, height=dst_h,
        )

    def to_dict(self, schema: str = "lean") -> dict:
        if schema == "lean":
            return {"fx": self.fx, "fy": self.fy, "cx": self.cx,
                    "cy": self.cy, "width": self.width, "height": self.height}
        if schema == "realsense":
            return {"fx": self.fx, "fy": self.fy, "ppx": self.cx,
                    "ppy": self.cy, "width": self.width,
                    "height": self.height,
                    "coeffs": list(map(float, self.dist[:5])),
                    "distortion_model": self.model}
        raise ValueError(f"unknown schema {schema!r}")


@dataclass(frozen=True)
class Extrinsics:
    """Rigid transform between two camera frames (e.g. depth -> color)."""

    R: np.ndarray  # (3,3)
    t: np.ndarray  # (3,)

    def __post_init__(self):
        object.__setattr__(self, "R", np.asarray(self.R, dtype=np.float64).reshape(3, 3))
        object.__setattr__(self, "t", np.asarray(self.t, dtype=np.float64).reshape(3))

    @property
    def T(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T

    def inverse(self) -> "Extrinsics":
        Rt = self.R.T
        return Extrinsics(R=Rt, t=-Rt @ self.t)

    @staticmethod
    def identity() -> "Extrinsics":
        return Extrinsics(R=np.eye(3), t=np.zeros(3))


def build_K(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """3x3 pinhole matrix (mpa_final_view_with_export.py:71-74)."""
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                    dtype=np.float64)


def scale_intrinsics(fx, fy, cx, cy, src_w, src_h, dst_w, dst_h):
    """Functional form kept for parity with the reference helper."""
    if src_w <= 0 or src_h <= 0 or (src_w == dst_w and src_h == dst_h):
        return fx, fy, cx, cy
    sx = float(dst_w) / float(src_w)
    sy = float(dst_h) / float(src_h)
    return fx * sx, fy * sy, cx * sx, cy * sy


def _intr_from_dict(d: dict) -> Intrinsics:
    if "ppx" in d:  # realsense schema
        return Intrinsics(
            fx=float(d["fx"]), fy=float(d["fy"]),
            cx=float(d["ppx"]), cy=float(d["ppy"]),
            width=int(d.get("width", 0)), height=int(d.get("height", 0)),
            dist=d.get("coeffs"),
            model=str(d.get("distortion_model", "brown_conrady")),
        )
    for k in ("fx", "fy", "cx", "cy"):
        if k not in d:
            raise KeyError(f"Missing '{k}' in intrinsics JSON")
    return Intrinsics(
        fx=float(d["fx"]), fy=float(d["fy"]),
        cx=float(d["cx"]), cy=float(d["cy"]),
        width=int(d.get("width", 0)), height=int(d.get("height", 0)),
        dist=d.get("dist_coeffs", d.get("coeffs")),
    )


def load_intrinsics_json(path, stream: str = "color") -> Intrinsics:
    """Load intrinsics from any of the reference JSON schemas.

    `stream` selects "color" or "depth" when the file is a bundle.
    """
    path = Path(path)
    data = json.loads(path.read_text())
    if isinstance(data, dict) and f"{stream}_intrinsics" in data:
        return _intr_from_dict(data[f"{stream}_intrinsics"])
    if isinstance(data, dict) and "color_intrinsics" in data:
        return _intr_from_dict(data["color_intrinsics"])
    return _intr_from_dict(data)


def load_extrinsics_json(path) -> Extrinsics:
    """Load extrinsics: {"R","t"}, {"R_dc","t_dc"} or a bundle with
    extrinsics.depth_to_color."""
    data = json.loads(Path(path).read_text())
    if "extrinsics" in data:
        data = data["extrinsics"].get("depth_to_color", data["extrinsics"])
    if "R_dc" in data:
        return Extrinsics(R=np.array(data["R_dc"]), t=np.array(data["t_dc"]))
    return Extrinsics(R=np.array(data["R"]), t=np.array(data["t"]))


def load_calibration_npz(path) -> Intrinsics:
    """Load the checkerboard-calibration NPZ schema
    (checkerboard_callibration.py:241-248)."""
    d = np.load(Path(path))
    K = np.asarray(d["K"], dtype=np.float64)
    dist = np.asarray(d["dist"], dtype=np.float64).reshape(-1)
    w, h = (int(x) for x in np.asarray(d["image_size"]).reshape(-1)[:2])
    return Intrinsics(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                      width=w, height=h, dist=dist)


def save_intrinsics_json(intr: Intrinsics, path, schema: str = "lean",
                         extra: Optional[dict] = None) -> None:
    d = intr.to_dict(schema)
    if extra:
        d.update(extra)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(d, indent=2))
