"""Error analysis and report writers.

Port of ``repas_tpu/eval/reports.py``. The host functions
(``load_picked_points``, ``_grade``, ``correspondence_report``,
``surface_error_report``, ``error_colormap``) are the reference's numpy
code, copied, so their txt/CSV/PNG layouts are the same byte for byte.
The point-to-mesh distances are dense (points x triangle chunk) sweeps in
PyTorch that run where their inputs lie.

  * load_picked_points — MeshLab/Open3D .pp picked-points XML parser
    (point_correspondence_error.py:6-32)
  * correspondence_report — per-landmark Euclidean/Manhattan/per-axis
    displacement, systematic-bias detection, quality grades, txt + CSV
    writers (point_correspondence_error.py:60-216,417-489). The txt/CSV
    column layout is the comparison surface for parity with the
    checked-in correspondence_errors.{txt,csv}.
  * point_to_mesh_distances / point_to_mesh_signed_distances — exact
    point-to-triangle distances, chunked over triangles on the device;
    compiled steps (``core.jit``, ``chunk`` static as in the reference):
    on the card one CUDA graph per shape holds every chunk of the loop
  * surface_error_report — percentile stats + histogram/CDF PNG +
    quality buckets (visualize_error.py:95-193)
"""
from __future__ import annotations

import functools
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.core.jit import jit

GRADES = [
    (5.0, "EXCELLENT"),
    (10.0, "GOOD"),
    (20.0, "ACCEPTABLE"),
    (50.0, "POOR"),
    (float("inf"), "BAD"),
]


def load_picked_points(path) -> np.ndarray:
    """Parse a MeshLab .pp picked-points XML file -> (N,3) float array."""
    root = ET.parse(Path(path)).getroot()
    pts = []
    for p in root.iter("point"):
        pts.append([float(p.get("x")), float(p.get("y")),
                    float(p.get("z"))])
    return np.asarray(pts, dtype=np.float64)


def _grade(err_mm: float) -> str:
    for lim, name in GRADES:
        if err_mm < lim:
            return name
    return "BAD"


def correspondence_report(ref_pts: np.ndarray, meas_pts: np.ndarray,
                          labels=None, txt_path=None, csv_path=None,
                          units_to_mm: float = 1000.0) -> dict:
    """Per-point displacement analysis between picked landmark pairs."""
    ref = np.asarray(ref_pts, dtype=np.float64)
    meas = np.asarray(meas_pts, dtype=np.float64)
    if ref.shape != meas.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {meas.shape}")
    n = len(ref)
    labels = labels or [f"point_{i+1}" for i in range(n)]
    d = (meas - ref) * units_to_mm
    eucl = np.linalg.norm(d, axis=1)
    manh = np.sum(np.abs(d), axis=1)
    mean_axis = d.mean(axis=0)
    # systematic bias: mean offset magnitude vs spread
    bias = np.linalg.norm(mean_axis)
    spread = np.linalg.norm(d - mean_axis, axis=1).mean()
    systematic = bool(bias > spread)

    rows = []
    for i in range(n):
        rows.append({
            "label": labels[i],
            "dx_mm": d[i, 0], "dy_mm": d[i, 1], "dz_mm": d[i, 2],
            "euclidean_mm": eucl[i], "manhattan_mm": manh[i],
            "grade": _grade(eucl[i]),
        })
    report = {
        "points": rows,
        "mean_euclidean_mm": float(eucl.mean()),
        "rmse_mm": float(np.sqrt((eucl ** 2).mean())),
        "max_euclidean_mm": float(eucl.max()),
        "mean_axis_offset_mm": mean_axis.tolist(),
        "systematic_bias": systematic,
        "overall_grade": _grade(float(eucl.mean())),
    }

    if txt_path:
        lines = ["=" * 64, "POINT CORRESPONDENCE ERROR ANALYSIS", "=" * 64,
                 f"pairs: {n}", ""]
        for r in rows:
            lines.append(
                f"{r['label']:>12}: dx={r['dx_mm']:+8.2f}  dy={r['dy_mm']:+8.2f}"
                f"  dz={r['dz_mm']:+8.2f}  |e|={r['euclidean_mm']:8.2f} mm"
                f"  [{r['grade']}]")
        lines += ["",
                  f"mean euclidean: {report['mean_euclidean_mm']:.3f} mm",
                  f"rmse:           {report['rmse_mm']:.3f} mm",
                  f"max:            {report['max_euclidean_mm']:.3f} mm",
                  f"axis bias (mm): {mean_axis.round(3).tolist()}",
                  f"systematic bias: {'YES' if systematic else 'no'}",
                  f"overall: {report['overall_grade']}", "=" * 64]
        Path(txt_path).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_path).write_text("\n".join(lines) + "\n")

    if csv_path:
        hdr = "label,dx_mm,dy_mm,dz_mm,euclidean_mm,manhattan_mm,grade"
        body = [f"{r['label']},{r['dx_mm']:.4f},{r['dy_mm']:.4f},"
                f"{r['dz_mm']:.4f},{r['euclidean_mm']:.4f},"
                f"{r['manhattan_mm']:.4f},{r['grade']}" for r in rows]
        Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
        Path(csv_path).write_text("\n".join([hdr] + body) + "\n")

    return report


# ---------------------------------------------------------------------------
# point-to-surface distances
# ---------------------------------------------------------------------------

def _dot(x, y):
    """Dot product of two 3-vectors given as component triples."""
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]


def _sub(x, y):
    return (x[0] - y[0], x[1] - y[1], x[2] - y[2])


def _point_tri_dist2(p, a, b, c):
    """Exact squared distance from points p (...,3) to triangles abc
    (...,3), broadcasting (device). The vectors are split into their
    components first, so every step is an elementwise op over the
    broadcast (points x triangles) shape with no (..., 3) intermediate."""
    p, a, b, c = (t.unbind(-1) for t in (p, a, b, c))
    ab = _sub(b, a)
    ac = _sub(c, a)
    ap = _sub(p, a)
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = _sub(p, b)
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = _sub(p, c)
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    denom = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    v = vb / denom
    w = vc / denom

    # interior projection
    proj = tuple(a[k] + v * ab[k] + w * ac[k] for k in range(3))

    def dist2(q):
        d = _sub(p, q)
        return _dot(d, d)

    def seg(s, e):
        d = _sub(e, s)
        t = torch.clamp(_dot(_sub(p, s), d) / torch.clamp(_dot(d, d),
                                                          min=1e-30),
                        0.0, 1.0)
        return dist2(tuple(s[k] + t * d[k] for k in range(3)))

    inside = (v >= 0) & (w >= 0) & (v + w <= 1)
    d_edges = torch.minimum(torch.minimum(seg(a, b), seg(b, c)), seg(a, c))
    return torch.where(inside, dist2(proj), d_edges)


def _corners(verts: torch.Tensor, tris: torch.Tensor):
    tris = tris.to(torch.int64)
    return verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]


@functools.partial(jit, static_argnames=("chunk",))
def point_to_mesh_distances(pts: torch.Tensor, verts: torch.Tensor,
                            tris: torch.Tensor, chunk: int = 256):
    """Exact unsigned point-to-mesh distances (N,) float32, chunked over
    triangles: a dense (N x chunk) sweep per chunk, no BVH."""
    a, b, c = _corners(verts, tris)
    best = torch.full((pts.shape[0],), torch.inf, dtype=torch.float32,
                      device=pts.device)
    p = pts[:, None, :]
    for s in range(0, a.shape[0], chunk):
        d = _point_tri_dist2(p, a[None, s:s + chunk], b[None, s:s + chunk],
                             c[None, s:s + chunk])
        best = torch.minimum(best, torch.amin(d, dim=1))
    return torch.sqrt(best)


@functools.partial(jit, static_argnames=("chunk",))
def point_to_mesh_signed_distances(pts: torch.Tensor, verts: torch.Tensor,
                                   tris: torch.Tensor, chunk: int = 256):
    """Exact signed point-to-mesh distances: negative inside, positive
    outside (Open3D RaycastingScene's compute_signed_distance convention).

    The sign is the plane side of the nearest triangle (its outward
    normal, for consistent CCW winding); the nearest triangle of a chunk
    is its first minimum, and a later chunk replaces it only when
    strictly nearer, as in the reference."""
    a, b, c = _corners(verts, tris)
    nrm = torch.linalg.cross(b - a, c - a)
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1,
                                                     keepdim=True),
                            min=1e-30)
    n = pts.shape[0]
    best_d2 = torch.full((n,), torch.inf, dtype=torch.float32,
                         device=pts.device)
    best_sign = torch.ones(n, dtype=torch.float32, device=pts.device)
    p = pts[:, None, :]
    for s in range(0, a.shape[0], chunk):
        aa, nn = a[s:s + chunk], nrm[s:s + chunk]
        d2 = _point_tri_dist2(p, aa[None], b[None, s:s + chunk],
                              c[None, s:s + chunk])            # (N, chunk)
        dmin, idx = torch.min(d2, dim=1)
        side = torch.sum((pts - aa[idx]) * nn[idx], dim=-1)
        sign = torch.where(side < 0, -1.0, 1.0)
        upd = dmin < best_d2
        best_d2 = torch.where(upd, dmin, best_d2)
        best_sign = torch.where(upd, sign, best_sign)
    return best_sign * torch.sqrt(best_d2)


def surface_error_report(dist_m: np.ndarray, txt_path=None, png_path=None,
                         units_to_mm: float = 1000.0) -> dict:
    """Percentile stats + quality buckets + optional histogram/CDF PNG
    (visualize_error.py:95-193).

    `dist_m` may be signed (point_to_mesh_signed_distances): magnitude
    stats follow the reference (it takes abs of RaycastingScene's signed
    output, visualize_error.py:36); a signed section (mean bias,
    inside/outside split) is added whenever negatives are present."""
    d_signed = np.asarray(dist_m, dtype=np.float64) * units_to_mm
    d = np.abs(d_signed)
    pct = {p: float(np.percentile(d, p)) for p in (5, 25, 50, 75, 90, 95, 99)}
    buckets = {
        "under_5mm": float((d < 5).mean()),
        "5_10mm": float(((d >= 5) & (d < 10)).mean()),
        "10_20mm": float(((d >= 10) & (d < 20)).mean()),
        "over_20mm": float((d >= 20).mean()),
    }
    report = {
        "count": int(d.size),
        "mean_mm": float(d.mean()),
        "median_mm": float(np.median(d)),
        "rmse_mm": float(np.sqrt((d ** 2).mean())),
        "std_mm": float(d.std()),
        "min_mm": float(d.min()),
        "max_mm": float(d.max()),
        "percentiles_mm": pct,
        "quality_distribution": buckets,
    }
    if (d_signed < 0).any():
        report["signed"] = {
            "mean_signed_mm": float(d_signed.mean()),
            "median_signed_mm": float(np.median(d_signed)),
            "inside_fraction": float((d_signed < 0).mean()),
            "outside_fraction": float((d_signed > 0).mean()),
            "p05_signed_mm": float(np.percentile(d_signed, 5)),
            "p95_signed_mm": float(np.percentile(d_signed, 95)),
        }
    if txt_path:
        lines = ["=" * 64, "POINT-TO-SURFACE ALIGNMENT ERROR", "=" * 64,
                 f"points analyzed: {report['count']}",
                 f"mean:   {report['mean_mm']:.3f} mm",
                 f"median: {report['median_mm']:.3f} mm",
                 f"rmse:   {report['rmse_mm']:.3f} mm",
                 f"std:    {report['std_mm']:.3f} mm",
                 f"min/max: {report['min_mm']:.3f} / {report['max_mm']:.3f} mm",
                 ""]
        for p, v in pct.items():
            lines.append(f"  p{p:02d}: {v:.3f} mm")
        lines.append("")
        for k, v in buckets.items():
            lines.append(f"  {k}: {100*v:.1f}%")
        if "signed" in report:
            s = report["signed"]
            lines += ["", "signed (negative = inside the surface):",
                      f"  mean bias: {s['mean_signed_mm']:+.3f} mm",
                      f"  median:    {s['median_signed_mm']:+.3f} mm",
                      f"  inside / outside: {100*s['inside_fraction']:.1f}%"
                      f" / {100*s['outside_fraction']:.1f}%",
                      f"  p05 / p95: {s['p05_signed_mm']:+.3f} /"
                      f" {s['p95_signed_mm']:+.3f} mm"]
        lines.append("=" * 64)
        Path(txt_path).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_path).write_text("\n".join(lines) + "\n")
    if png_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        ax1.hist(d, bins=60, color="#4878cf")
        ax1.set_xlabel("error (mm)")
        ax1.set_ylabel("count")
        ax1.set_title("error histogram")
        xs = np.sort(d)
        ax2.plot(xs, np.linspace(0, 1, len(xs)), color="#d65f5f")
        ax2.set_xlabel("error (mm)")
        ax2.set_ylabel("CDF")
        ax2.set_title("cumulative distribution")
        fig.tight_layout()
        Path(png_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(png_path, dpi=110)
        plt.close(fig)
    return report


def error_colormap(dist_m: np.ndarray, max_mm: float = 30.0) -> np.ndarray:
    """Green -> red colormap on distance magnitudes (visualize_error.py:55-93;
    the reference also colors by abs of the signed distance).
    Returns (N,3) float colors in [0,1]."""
    t = np.clip(np.abs(np.asarray(dist_m)) * 1000.0 / max_mm, 0.0, 1.0)
    return np.stack([t, 1.0 - t, np.zeros_like(t)], axis=1)
