"""Depth colorizer — the rs.colorizer equivalent (C27 / VERDICT r3 #8).

The reference previews aligned depth with librealsense's colorizer
(capture_aligned_all.py:81,206; bag_to_img.py:30-41): histogram-equalized
JET colormap over valid depth, invalid (zero) pixels black. This module
reproduces those semantics on a numpy depth array so capture/preview
tooling can write the same `depth_cm_*.png` artifacts offline.

Host-side visualization utility by design (one small LUT pass per saved
preview); the device compute path never consumes colorized depth.

Port of ``repas_tpu/viz/colormap.py``, copied (host numpy).
"""
from __future__ import annotations

import numpy as np


def jet_colormap(t: np.ndarray) -> np.ndarray:
    """Classic JET colormap: t in [0,1] -> (..., 3) uint8 RGB.

    Piecewise-linear blue->cyan->yellow->red ramp matching the
    rs.colorizer / cv2.COLORMAP_JET shape (blue at 0, red at 1).
    """
    t = np.clip(np.asarray(t, np.float32), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * t - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def colorize_depth(depth_m: np.ndarray, min_m: float | None = None,
                   max_m: float | None = None,
                   hist_eq: bool = True) -> np.ndarray:
    """Colorize a float-meters depth map to (H,W,3) uint8 RGB.

    rs.colorizer defaults: histogram equalization ON (each valid depth
    maps to its rank among valid pixels, so the full color range is
    used regardless of scene depth span); with hist_eq=False a linear
    [min_m, max_m] window is used (rs.option.min/max_distance). Invalid
    (<= 0 / non-finite) pixels render black.
    """
    d = np.asarray(depth_m, np.float32)
    valid = np.isfinite(d) & (d > 0)
    t = np.zeros(d.shape, np.float32)
    if valid.any():
        if hist_eq:
            # rank-equalize via a 1024-bin CDF over valid depths
            v = d[valid]
            lo, hi = float(v.min()), float(v.max())
            if hi - lo < 1e-9:
                t[valid] = 0.5
            else:
                hist, edges = np.histogram(v, bins=1024, range=(lo, hi))
                cdf = np.cumsum(hist).astype(np.float32)
                cdf /= cdf[-1]
                idx = np.clip(((v - lo) / (hi - lo) * 1023).astype(np.int64),
                              0, 1023)
                t[valid] = cdf[idx]
        else:
            lo = float(min_m) if min_m is not None else float(d[valid].min())
            hi = float(max_m) if max_m is not None else float(d[valid].max())
            t[valid] = (d[valid] - lo) / max(hi - lo, 1e-9)
    rgb = jet_colormap(t)
    rgb[~valid] = 0
    return rgb
