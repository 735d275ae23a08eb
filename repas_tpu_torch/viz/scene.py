"""Host-side visualization (C24/C29 equivalents, headless).

The reference's interactive Open3D windows (draw_geometries everywhere)
and OpenCV HUDs cannot run headless; the same scenes render to PNG via
matplotlib: detection overlays (april_tag_2D_viz.py), point-cloud scatter
views (visualize_ply.py:1-35, view_point_cloud.py), grid/axes helpers
(make_xy_grid / colored_axes_lines, final_view.py:148-162).

Port of ``repas_tpu/viz/scene.py``, copied (host numpy and a lazily
imported matplotlib).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_detections(rgb: np.ndarray, detections, path=None):
    """Overlay detected tag corners/ids on the image
    (april_tag_2D_viz.py-style)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(rgb, cmap="gray" if rgb.ndim == 2 else None)
    ids = np.asarray(detections.ids)
    corners = np.asarray(detections.corners)
    valid = np.asarray(detections.valid)
    for i in range(len(ids)):
        if not valid[i]:
            continue
        c = corners[i]
        poly = np.vstack([c, c[:1]])
        ax.plot(poly[:, 0], poly[:, 1], "-", color="lime", lw=2)
        ax.plot(c[0, 0], c[0, 1], "o", color="red", ms=6)  # TL marker
        ctr = c.mean(axis=0)
        ax.text(ctr[0], ctr[1], str(ids[i]), color="yellow", fontsize=14,
                ha="center", weight="bold")
    ax.axis("off")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def draw_reprojection_compare(rgb, detected_corners, reprojected_corners,
                              ids=None, path=None):
    """Detected vs reprojected corner polygons per tag
    (april_tag_2D_viz.py:223-279 combined plot)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(rgb, cmap="gray" if np.asarray(rgb).ndim == 2 else None)
    det = np.asarray(detected_corners).reshape(-1, 4, 2)
    rep = np.asarray(reprojected_corners).reshape(-1, 4, 2)
    for k in range(len(det)):
        d = np.vstack([det[k], det[k][:1]])
        r = np.vstack([rep[k], rep[k][:1]])
        ax.plot(d[:, 0], d[:, 1], "-o", color="lime", ms=3, lw=1.5,
                label="detected" if k == 0 else None)
        ax.plot(r[:, 0], r[:, 1], "--s", color="red", ms=3, lw=1.5,
                label="reprojected" if k == 0 else None)
        if ids is not None:
            c = det[k].mean(axis=0)
            ax.text(c[0], c[1], str(int(np.asarray(ids).reshape(-1)[k])),
                    color="yellow", fontsize=12, ha="center")
    ax.legend(loc="upper right")
    ax.axis("off")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def axes_points(size: float = 0.05, n: int = 20):
    """Colored axis line points (colored_axes_lines equivalent as point
    sets). Returns (points (3n,3), colors (3n,3))."""
    t = np.linspace(0, size, n)
    zeros = np.zeros(n)
    pts = np.concatenate([
        np.column_stack([t, zeros, zeros]),
        np.column_stack([zeros, t, zeros]),
        np.column_stack([zeros, zeros, t])])
    cols = np.concatenate([
        np.tile([1.0, 0, 0], (n, 1)),
        np.tile([0, 1.0, 0], (n, 1)),
        np.tile([0, 0, 1.0], (n, 1))])
    return pts, cols


def sphere_points(center, radius: float = 0.003, n: int = 64):
    """Marker-sphere point set (sphere builder role,
    april_tag_bg_removal_pl.py:214-270)."""
    golden = np.pi * (3 - np.sqrt(5))
    i = np.arange(n)
    z = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(1 - z * z)
    th = golden * i
    pts = np.column_stack([r * np.cos(th), r * np.sin(th), z]) * radius
    return pts + np.asarray(center)


def aabb_wireframe_segments(lo, hi):
    """12 edge segments of an axis-aligned box (AABB wireframe builder)."""
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    c = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                  [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                  [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                  [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]])
    e = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.stack([np.stack([c[a], c[b]]) for a, b in e])


def line_points(p0, p1, n: int = 32):
    """Dense points along a segment (line builder role)."""
    t = np.linspace(0.0, 1.0, n)[:, None]
    return np.asarray(p0)[None] * (1 - t) + np.asarray(p1)[None] * t


def save_color_scale(path, max_mm: float = 30.0):
    """Green->red error colormap legend (visualize_error.py color_scale.png)."""
    plt = _plt()
    t = np.linspace(0, 1, 256)
    bar = np.stack([t, 1 - t, np.zeros_like(t)], axis=1)[None].repeat(24, 0)
    fig, ax = plt.subplots(figsize=(6, 1.2))
    ax.imshow(bar, extent=[0, max_mm, 0, 1], aspect="auto")
    ax.set_yticks([])
    ax.set_xlabel("error (mm)")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def make_xy_grid_lines(cell: float = 0.1, n: int = 20, z: float = 0.0):
    """Grid line segments [(p0,p1), ...] (make_xy_grid equivalent)."""
    extent = n * cell
    segs = []
    for v in np.linspace(-extent, extent, 2 * n + 1):
        segs.append(([-extent, v, z], [extent, v, z]))
        segs.append(([v, -extent, z], [v, extent, z]))
    return np.asarray(segs)


def plot_pointcloud(points: np.ndarray, colors=None, path=None,
                    elev: float = -70.0, azim: float = -90.0,
                    max_points: int = 100_000, extra_points=None):
    """3-D scatter view of a cloud (visualize_ply.py equivalent)."""
    plt = _plt()
    pts = np.asarray(points)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[idx]
        colors = None if colors is None else np.asarray(colors)[idx]
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3,
               c=colors if colors is not None else pts[:, 2],
               cmap=None if colors is not None else "viridis")
    if extra_points is not None:
        ep, ec = extra_points
        ax.scatter(ep[:, 0], ep[:, 1], ep[:, 2], s=8, c=ec)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def save_pointcloud_views(points, colors, out_prefix,
                          views=((-70, -90), (-20, -45), (0, 0))):
    """Multiple fixed viewpoints as PNGs (headless substitute for the
    interactive viewer's orbit)."""
    paths = []
    for i, (elev, azim) in enumerate(views):
        p = Path(f"{out_prefix}_view{i}.png")
        plot_pointcloud(points, colors, p, elev=elev, azim=azim)
        paths.append(p)
    return paths
