"""Synthetic tag renderer (host-side numpy): test and smoke-frame generator.

Port of ``repas_tpu/detect/render.py`` (``tag_grid``, ``render_tag``,
``tag_corner_px``, ``_undistort_normalized_np``, ``render_tag_in_scene``
with or without a Brown-Conrady lens) plus ``example_frame``, the port's
copy of the bench frame that ``__graft_entry__._example_frame`` builds for
the JAX package.
"""
from __future__ import annotations

import numpy as np

from repas_tpu_torch.detect.tag_families import TAG36H11_CODES, code_to_bits

CELLS = 8          # black border + 6x6 data
MARGIN_CELLS = 2   # white quiet zone around the tag, in cells


def tag_grid(tag_id: int) -> np.ndarray:
    """(8,8) float grid: 1=white, 0=black, border included."""
    g = np.zeros((CELLS, CELLS), dtype=np.float32)
    g[1:-1, 1:-1] = code_to_bits(TAG36H11_CODES[tag_id]).astype(np.float32)
    return g


def render_tag(tag_id: int, cell_px: int = 16, white: float = 220.0,
               black: float = 30.0) -> np.ndarray:
    """Fronto-parallel tag image with a white margin.

    Returns (S,S) float32 grayscale, S = (8 + 2*MARGIN_CELLS) * cell_px.
    """
    g = tag_grid(tag_id)
    total = CELLS + 2 * MARGIN_CELLS
    canvas = np.ones((total, total), dtype=np.float32)
    canvas[MARGIN_CELLS:MARGIN_CELLS + CELLS,
           MARGIN_CELLS:MARGIN_CELLS + CELLS] = g
    img = np.kron(canvas, np.ones((cell_px, cell_px), dtype=np.float32))
    return black + (white - black) * img


def tag_corner_px(cell_px: int = 16) -> np.ndarray:
    """Outer-border corner pixel coords (TL,TR,BR,BL) of render_tag output."""
    a = MARGIN_CELLS * cell_px - 0.5
    b = (MARGIN_CELLS + CELLS) * cell_px - 0.5
    return np.array([[a, a], [b, a], [b, b], [a, b]], dtype=np.float32)


def _undistort_normalized_np(xd: np.ndarray, yd: np.ndarray, dist,
                             iters: int = 25):
    """Invert the 8-coefficient Brown-Conrady model by fixed-point steps,
    in float64 (kernels.project.distort_normalized's convention)."""
    k = list(np.asarray(dist, np.float64).reshape(-1)) + [0.0] * 8
    k1, k2, p1, p2, k3, k4, k5, k6 = k[:8]
    x, y = xd.astype(np.float64), yd.astype(np.float64)
    for _ in range(iters):
        r2 = x * x + y * y
        radial = ((1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
                  / (1 + r2 * (k4 + r2 * (k5 + r2 * k6))))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def render_tag_in_scene(tag_id: int, pose_R: np.ndarray, pose_t: np.ndarray,
                        K: np.ndarray, tag_size_m: float,
                        img_shape: tuple[int, int],
                        background: float = 180.0, white: float = 220.0,
                        black: float = 30.0, supersample: int = 2,
                        dist=None) -> np.ndarray:
    """Render a posed tag into a gray background via inverse homography.

    The tag plane carries the tag centered at its origin with outer-border
    half-size tag_size_m/2. Returns (H,W) float32 grayscale. With a
    non-zero `dist` each pixel is undistorted before the plane lookup, so
    the image is what a distorting camera would capture.
    """
    h, w = img_shape
    half = tag_size_m / 2.0
    A = np.column_stack([pose_R[:, 0], pose_R[:, 1], pose_t])

    ss = supersample
    ys, xs = np.meshgrid(
        (np.arange(h * ss) + 0.5) / ss - 0.5,
        (np.arange(w * ss) + 0.5) / ss - 0.5, indexing="ij")
    if dist is not None and np.any(np.asarray(dist) != 0):
        xu, yu = _undistort_normalized_np((xs - K[0, 2]) / K[0, 0],
                                          (ys - K[1, 2]) / K[1, 1], dist)
        pts = np.stack([xu, yu, np.ones_like(xu)],
                       axis=-1) @ np.linalg.inv(A).T
    else:
        Hinv = np.linalg.inv(K @ A)
        pts = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Hinv.T
    tx = pts[..., 0] / pts[..., 2]
    ty = pts[..., 1] / pts[..., 2]

    total_half = half * (CELLS + 2 * MARGIN_CELLS) / CELLS
    inside_margin = (np.abs(tx) <= total_half) & (np.abs(ty) <= total_half)
    inside_tag = (np.abs(tx) <= half) & (np.abs(ty) <= half)

    cell = CELLS / (2 * half)
    cx = np.clip(((tx + half) * cell).astype(np.int32), 0, CELLS - 1)
    cy = np.clip(((ty + half) * cell).astype(np.int32), 0, CELLS - 1)
    g = tag_grid(tag_id)
    val_tag = black + (white - black) * g[cy, cx]

    img = np.full((h * ss, w * ss), background, dtype=np.float32)
    img[inside_margin] = white
    img[inside_tag] = val_tag[inside_tag]
    img = img.reshape(h, ss, w, ss).mean(axis=(1, 3))
    return img


def example_frame(h: int, w: int, tag_id: int = 9, tag_frac: float = 0.3,
                  z: float = 0.45):
    """Synthetic RGB + aligned u16 depth frame holding one fronto-parallel
    tag at depth z (the JAX package's bench frame).

    tag_frac: tag side length as a fraction of min(h, w).
    Returns (rgb (H,W,3) uint8, depth (H,W) uint16 mm, K (3,3) float32).
    """
    f = 0.6 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]],
                 dtype=np.float32)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.0, 0.0, z], dtype=np.float32)
    tag_size_m = tag_frac * min(h, w) * z / f
    gray = render_tag_in_scene(tag_id, R, t, K, tag_size_m, (h, w),
                               supersample=1)
    rgb = np.repeat(gray[..., None], 3, axis=-1).astype(np.uint8)
    depth = np.full((h, w), int(z * 1000), dtype=np.uint16)
    return rgb, depth, K
