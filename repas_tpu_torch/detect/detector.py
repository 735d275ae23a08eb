"""Batched tag36h11 AprilTag detector.

Port of ``repas_tpu/detect/detector.py`` (``Detections``,
``_support_points``, ``_quad_from_support``, ``_refine_edges``,
``_apply_h``, ``_sharpen_grid``, ``_decode_quad``, ``detect_tags``,
``detect_tags_batch``) with
the frame batch written out: every stage works on (B, ...) tensors and
the candidate slots are a second fixed dimension, so there is no Python
loop over frames or candidates and no host sync.

  1. grayscale, decimate by quad_decimate              (kernels/image.py)
  2. tile adaptive threshold, low-contrast exclusion
  3. connected components on dark pixels, converged     (kernel B1)
  4. ring-filtered top-K components
  5. extremal support points over 16 directions; quads
  6. bf16 row-concatenated pyramid; per-candidate windows (kernel B2)
  7. two subpixel edge-refine passes (hat-matmul sampler)
  8. 8x8 decode against the 587-code table under 4 rotations
  9. top-D compaction by decision margin

With ``with_candidates`` it also returns every candidate quad's bbox and
tag-likeness score, which the robust ladder escalates on.

Two departures from the reference make a tag turned in plane decode at
any angle (the reference misses large turned tags, and tags turned near
22.5 + 45k degrees): the labels run to their fixed point
(``config.ccl_iters`` is the least number of rounds), so a turned
border ring is one component; and a support point no longer lands
outside its component where a slanted edge ties (``_support_points``'
tie rule). Where the reference's labels had converged and no slanted
edge tied, the two detectors agree bit for bit.

``detect_tags_jit`` is the compiled step (``core.jit``, ``config`` and
``with_candidates`` static as in the reference) beside ``detect_tags``,
which stays plain: the eager ``process_frames`` and the compiled steps
that call it (the pipeline's, the tracker's, the ladder's) capture no
graph of their own for it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repas_tpu_torch.core.config import DetectorConfig
from repas_tpu_torch.core.consts import const
from repas_tpu_torch.core.jit import jit, pin
from repas_tpu_torch.core.transforms import homography_from_unit_square
from repas_tpu_torch.detect import tag_families
from repas_tpu_torch.kernels.ccl import (connected_components,
                                         top_k_components, top_k_stable)
from repas_tpu_torch.kernels.image import (adaptive_threshold,
                                           bilinear_sample_patch, decimate,
                                           gaussian_blur, rgb_to_gray)
from repas_tpu_torch.kernels.patch_extract import (ROW_TILE,
                                                   extract_patches_pyramid,
                                                   extract_windows_plain)

# side of the per-candidate ROI window used for support points, refine
# and decode; larger quads use a decimated pyramid level of the same size
_PATCH = 192
# px a quad keeps from its window's edges (refine search room)
_MARGIN = 12.0

_NDIRS = 16

# edge-sample positions of _refine_edges: the reference's
# jnp.linspace(0.12, 0.88, 12) as float32. torch.linspace rounds five of
# them one ulp differently, and refined corners follow these positions.
_EDGE_TS = (0.12, 0.18909091, 0.2581818, 0.32727274, 0.39636365, 0.46545458,
            0.5345455, 0.6036364, 0.6727273, 0.74181825, 0.81090915, 0.88)


class Detections(NamedTuple):
    """Fixed-capacity detection set (slot i meaningful where valid[i])."""

    ids: torch.Tensor               # (B,D) int32, -1 when invalid
    corners: torch.Tensor           # (B,D,4,2) f32, canonical TL,TR,BR,BL
    centers: torch.Tensor           # (B,D,2) f32
    decision_margin: torch.Tensor   # (B,D) f32
    hamming: torch.Tensor           # (B,D) int32
    areas: torch.Tensor             # (B,D) f32 (component pixel areas)
    valid: torch.Tensor             # (B,D) bool


def _gather_last2(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (...,N,K), idx (...,M) -> x[..., idx, :] (...,M,K)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _support_points(labels: torch.Tensor, roots: torch.Tensor,
                    bbox: torch.Tensor) -> torch.Tensor:
    """Extremal support points of each component along _NDIRS directions.

    labels (B,H,W) int32; roots (B,C) root label per slot; bbox (B,C,4)
    approximate [xmin,ymin,xmax,ymax] per slot. Returns (B,C,_NDIRS,2).

    Masked reductions over one label window per slot; components larger
    than a window use a stride-2^l subsample of the same ROI. Per row only
    the min-x and max-x member pixels are candidates: they contain a
    maximizer for every direction.

    Ties: the candidates within 1e-3 of a direction's maximum all support
    it. The reference returns the largest x and the largest y among them,
    the corner of their bounding box. Where a tag edge lies normal to the
    direction at a slant, the tied pixels are a staircase and that corner
    lies far outside the component (tens of pixels on a large tag turned
    45 degrees), so the quad takes it and the decode fails. Here the
    corner is returned where it is a tied candidate (an upright edge) or
    where the tied candidates span at most one pixel (of the window's
    level) in x and in y: two pixels beside a corner pixel that noise or
    decimation removed, the corner itself. Otherwise the tied candidate
    farthest along the direction turned +90 degrees: one end of the
    tied edge, a pixel of the component.
    """
    B, h, w = labels.shape
    dev = labels.device
    ph, pw = min(_PATCH, h), min(_PATCH, w)
    m_pad = 8
    cover_x, cover_y = pw - 2 * m_pad, ph - 2 * m_pad
    n_levels = 1
    while (cover_x * 2 ** (n_levels - 1) < w
           or cover_y * 2 ** (n_levels - 1) < h) and n_levels < 4:
        n_levels += 1

    # label pyramid by pure subsampling, row-concatenated; sentinel
    # padding (= background) never matches a root
    sentinel = h * w
    row_off, rows = [], []
    for lv in range(n_levels):
        a = labels[:, :: 2 ** lv, :: 2 ** lv]
        hl_, wl_ = a.shape[-2:]
        row_off.append(sum(r.shape[1] for r in rows))
        rows.append(F.pad(a, (0, w - wl_, 0, max(ph - hl_, 0)),
                          value=sentinel))
    pyr = torch.cat(rows, dim=1)
    row_off = const(tuple(row_off), torch.int32, dev)

    starts_l, fits_l = [], []
    for lv in range(n_levels):
        s = 2 ** lv
        hl_ = max(rows[lv].shape[1], ph)
        wl_ = -(-w // s)
        starts_l.append(torch.stack([
            torch.clamp(torch.floor(bbox[..., 0] / s).to(torch.int32) - m_pad,
                        0, max(wl_ - pw, 0)),
            torch.clamp(torch.floor(bbox[..., 1] / s).to(torch.int32) - m_pad,
                        0, max(hl_ - ph, 0))], dim=-1))
        fits_l.append(((bbox[..., 2] - bbox[..., 0]) / s <= cover_x)
                      & ((bbox[..., 3] - bbox[..., 1]) / s <= cover_y))
    fits_all = torch.stack(fits_l, dim=-1)                # (B,C,L)
    lvl = torch.where(torch.any(fits_all, dim=-1),
                      torch.argmax(fits_all.to(torch.int32), dim=-1),
                      n_levels - 1)
    starts = _gather_last2(torch.stack(starts_l, dim=-2), lvl[..., None])[
        ..., 0, :]                                         # (B,C,2) [x,y]
    scale = torch.exp2(lvl.to(torch.float32))             # (B,C)

    origins = torch.stack([row_off[lvl] + starts[..., 1], starts[..., 0]],
                          dim=-1)
    patches = extract_windows_plain(pyr, origins, ph, pw)  # (B,C,ph,pw)

    member = patches == roots[..., None, None]
    colf = torch.arange(pw, dtype=torch.float32, device=dev)
    neg = -1e9
    maxx = torch.amax(torch.where(member, colf, neg), dim=-1)   # (B,C,ph)
    minx = torch.amin(torch.where(member, colf, -neg), dim=-1)
    has = maxx > neg
    rowf = torch.arange(ph, dtype=torch.float32, device=dev)
    cand_col = torch.cat([minx, maxx], dim=-1)            # (B,C,2ph)
    cand_row = torch.cat([rowf, rowf])                    # (2ph,)
    cand_ok = torch.cat([has, has], dim=-1)
    st_f = starts.to(torch.float32)
    xs = (st_f[..., 0:1] + cand_col) * scale[..., None]
    ys = (st_f[..., 1:2] + cand_row) * scale[..., None]
    xs = torch.where(cand_ok, xs, 0.0)
    ys = torch.where(cand_ok, ys, 0.0)

    thetas = np.pi * 2.0 * np.arange(_NDIRS) / _NDIRS
    c = const(tuple(np.cos(thetas).astype(np.float32).tolist()),
              torch.float32, dev)
    s = const(tuple(np.sin(thetas).astype(np.float32).tolist()),
              torch.float32, dev)
    # the root pixel is always a member: folding it in keeps every
    # direction's support finite
    x_root = (roots % w).to(torch.float32)[..., None]     # (B,C,1)
    y_root = (roots // w).to(torch.float32)[..., None]

    # all directions at once: (B,C,_NDIRS,2ph)
    proj = xs[..., None, :] * c[:, None] + ys[..., None, :] * s[:, None]
    pm = torch.where(cand_ok[..., None, :], proj, neg)
    proj_root = x_root * c + y_root * s                   # (B,C,_NDIRS)
    mx = torch.maximum(torch.amax(pm, dim=-1), proj_root)
    win = pm >= (mx[..., None] - 1e-3)
    root_win = proj_root >= (mx - 1e-3)
    xw, yw = xs[..., None, :], ys[..., None, :]
    ux = torch.amax(torch.where(win, xw, neg), dim=-1)
    uy = torch.amax(torch.where(win, yw, neg), dim=-1)
    ux = torch.maximum(ux, torch.where(root_win, x_root, neg))
    uy = torch.maximum(uy, torch.where(root_win, y_root, neg))
    # keep (ux, uy) where it is a tied candidate, or where the tied
    # candidates span at most a pixel of the level (their low corner)
    lx = torch.minimum(torch.amin(torch.where(win, xw, -neg), dim=-1),
                       torch.where(root_win, x_root, -neg))
    ly = torch.minimum(torch.amin(torch.where(win, yw, -neg), dim=-1),
                       torch.where(root_win, y_root, -neg))
    keep = (torch.any(win & (xw == ux[..., None]) & (yw == uy[..., None]),
                      dim=-1)
            | (root_win & (x_root == ux) & (y_root == uy))
            | ((ux - lx <= scale[..., None]) & (uy - ly <= scale[..., None])))
    # else the tied candidate farthest along (-sin, cos); distinct tied
    # points differ there by about a pixel, so only a repeated point ties
    perp = torch.where(win, ys[..., None, :] * c[:, None]
                       - xs[..., None, :] * s[:, None], neg)
    perp_root = torch.where(root_win, y_root * c - x_root * s, neg)
    pmx = torch.maximum(torch.amax(perp, dim=-1), perp_root)
    end = win & (perp >= pmx[..., None])
    end_root = root_win & (perp_root >= pmx)
    ex = torch.maximum(torch.amax(torch.where(end, xw, neg), dim=-1),
                       torch.where(end_root, x_root, neg))
    ey = torch.maximum(torch.amax(torch.where(end, yw, neg), dim=-1),
                       torch.where(end_root, y_root, neg))
    return torch.stack([torch.where(keep, ux, ex),
                        torch.where(keep, uy, ey)], dim=-1)  # (B,C,_NDIRS,2)


def _tri_area(a, b, c):
    return 0.5 * ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                  - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def _sqdist(a, b):
    d = a - b
    return torch.sum(d * d, dim=-1)


def _quad_from_support(sup: torch.Tensor) -> torch.Tensor:
    """4 corner candidates from (...,_NDIRS,2) support points:
    farthest-point + max-area selection, then sorted by angle about the
    quad centroid. Returns (...,4,2)."""
    cg = torch.mean(sup, dim=-2, keepdim=True)
    p0 = _gather_last2(sup, torch.argmax(_sqdist(sup, cg), dim=-1)[..., None])
    p1 = _gather_last2(sup, torch.argmax(_sqdist(sup, p0), dim=-1)[..., None])
    a2 = _tri_area(p0, p1, sup)                           # (...,_NDIRS)
    p2 = _gather_last2(sup, torch.argmax(torch.abs(a2), dim=-1)[..., None])
    s2 = _tri_area(p0, p1, p2)                            # (...,1)
    # fourth corner: extreme on the opposite side of the p0-p1 line
    a3 = torch.where(torch.sign(a2) != torch.sign(s2), torch.abs(a2), 0.0)
    p3 = _gather_last2(sup, torch.argmax(a3, dim=-1)[..., None])
    quad = torch.cat([p0, p1, p2, p3], dim=-2)            # (...,4,2)
    c = torch.mean(quad, dim=-2, keepdim=True)
    ang = torch.atan2(quad[..., 1] - c[..., 1], quad[..., 0] - c[..., 0])
    order = torch.argsort(ang, dim=-1, stable=True)
    return _gather_last2(quad, order)


def _refine_edges(patches: torch.Tensor, quad: torch.Tensor,
                  search: float = 2.0, offset_step: float = 0.5
                  ) -> torch.Tensor:
    """Subpixel edge refinement of (N,4,2) quads in patch coordinates,
    sampling the (N,h,w) patches with the hat-matmul sampler.

    For each edge, sample the intensity profile along the edge normal,
    localize the gradient peak by a 3-point parabola fit, fit a
    peak-strength-weighted line, and re-intersect adjacent lines. A
    corner that moves by 2*search or more keeps its input position.
    """
    dev = quad.device
    rolled = torch.roll(quad, -1, dims=-2)
    ts = const(_EDGE_TS, torch.float32, dev)
    n_offsets = 2 * int(round(search / offset_step)) + 1
    offs = torch.linspace(-search, search, n_offsets, device=dev)
    step = 2.0 * search / (n_offsets - 1)

    # all four edges at once; edge i runs from corner i to corner i+1
    d = rolled - quad                                      # (N,4,2)
    length = torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-9
    t_hat = d / length
    n_hat = torch.stack([-t_hat[..., 1], t_hat[..., 0]], dim=-1)
    base = quad[..., None, :] + ts[:, None] * d[..., None, :]   # (N,4,S,2)
    samp = base[..., None, :] + offs[:, None] * n_hat[..., None, None, :]
    vals = bilinear_sample_patch(patches, samp)           # (N,4,S,O)
    grad = torch.abs(vals[..., 2:] - vals[..., :-2])      # (N,4,S,O-2)
    j = torch.clamp(torch.argmax(grad, dim=-1), 1, grad.shape[-1] - 2)
    g0 = torch.gather(grad, -1, (j - 1)[..., None])[..., 0]
    g1 = torch.gather(grad, -1, j[..., None])[..., 0]
    g2 = torch.gather(grad, -1, (j + 1)[..., None])[..., 0]
    denom = g0 - 2.0 * g1 + g2
    frac = torch.where(torch.abs(denom) > 1e-6, 0.5 * (g0 - g2) / denom, 0.0)
    o_peak = -search + (j + 1).to(vals.dtype) * step
    o_star = o_peak + torch.clamp(frac, -1.0, 1.0) * step
    pts = base + o_star[..., None] * n_hat[..., None, :]  # (N,4,S,2)
    # peak-strength-weighted line fit: direction = principal axis
    wsum = g1 + 1e-6
    mu = (torch.sum(pts * wsum[..., None], dim=-2)
          / torch.sum(wsum, dim=-1)[..., None])            # (N,4,2)
    dp = (pts - mu[..., None, :]) * torch.sqrt(wsum)[..., None]
    cov = dp.transpose(-1, -2) @ dp                       # (N,4,2,2)
    c00, c01 = cov[..., 0, 0], cov[..., 0, 1]
    c10, c11 = cov[..., 1, 0], cov[..., 1, 1]
    tr = c00 + c11
    det = c00 * c11 - c01 * c10
    lam = tr / 2 + torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    v1 = torch.stack([c01, lam - c00], dim=-1)
    v2 = torch.stack([lam - c11, c10], dim=-1)
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    n2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    v = torch.where(n1 >= n2, v1, v2)
    scale = torch.sqrt(torch.clamp(lam, min=1e-12))[..., None]
    nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v = torch.where(nv < 1e-6 * scale, t_hat, v / (nv + 1e-12))

    # corner i = intersection of edge (i-1 -> i) and edge (i -> i+1)
    mu1, vv1 = torch.roll(mu, 1, dims=-2), torch.roll(v, 1, dims=-2)
    rhs = mu - mu1
    a00, a01 = vv1[..., 0], -v[..., 0]
    a10, a11 = vv1[..., 1], -v[..., 1]
    det = a00 * a11 - a01 * a10
    a = (rhs[..., 0] * a11 - rhs[..., 1] * a01) / torch.where(
        torch.abs(det) < 1e-9, 1e-9, det)
    corners = mu1 + a[..., None] * vv1
    ok = torch.linalg.vector_norm(corners - quad, dim=-1) < 2.0 * search
    return torch.where(ok[..., None], corners, quad)


def _apply_h(H: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Homographies (N,3,3) applied to shared points (...,2) -> (N,...,2)."""
    p = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1).reshape(-1, 3)
    q = p @ H.transpose(-1, -2)                           # (N,P,3)
    return (q[..., :2] / q[..., 2:3]).reshape(H.shape[0], *xy.shape)


def _sharpen_grid(vals: torch.Tensor, amount: float) -> torch.Tensor:
    """decode_sharpening: v + a * laplacian(v) on (N,8,8) sample grids."""
    p = F.pad(vals[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    lap = (4.0 * vals - p[:, :-2, 1:-1] - p[:, 2:, 1:-1]
           - p[:, 1:-1, :-2] - p[:, 1:-1, 2:])
    return vals + amount * lap


def _solve_spd3(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 SPD solve via the adjugate: M (...,3,3), rhs (...,3)."""
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 0, 2] * M[..., 2, 1] - M[..., 0, 1] * M[..., 2, 2]
    c02 = M[..., 0, 1] * M[..., 1, 2] - M[..., 0, 2] * M[..., 1, 1]
    c10 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
    c11 = M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0]
    c12 = M[..., 0, 2] * M[..., 1, 0] - M[..., 0, 0] * M[..., 1, 2]
    c20 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
    c21 = M[..., 0, 1] * M[..., 2, 0] - M[..., 0, 0] * M[..., 2, 1]
    c22 = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    det = M[..., 0, 0] * c00 + M[..., 0, 1] * c10 + M[..., 0, 2] * c20
    adj = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                       torch.stack([c10, c11, c12], dim=-1),
                       torch.stack([c20, c21, c22], dim=-1)], dim=-2)
    return (adj @ rhs[..., None])[..., 0] / det[..., None]


@functools.lru_cache(maxsize=8)
def _decode_tables(device: torch.device):
    """The active codebook's bits (N,36) bool (N = 587 for the default
    table) and rotation permutations (4,36), copied to `device` once;
    ``tag_families.set_active_codebook`` clears this cache and every
    captured graph (``core.jit.clear_caches``); a graph pins the tables it
    reads."""
    return (torch.as_tensor(tag_families.tag_family_bits(), device=device),
            torch.as_tensor(tag_families.rotation_perms(), dtype=torch.int64,
                            device=device))


def _decode_quad(quad: torch.Tensor, table: torch.Tensor, perms: torch.Tensor,
                 sharpening: float, max_hamming: int, sampler):
    """Decode (N,4,2) quads. `sampler(pts)` maps full-resolution pixel
    coords (N,...,2) to intensities (N,...).

    Returns (ids (N,), rotation k (N,), hamming (N,), margin (N,),
    corners (N,4,2) rolled to canonical TL,TR,BR,BL order, tagness (N,)
    the quad's tag-likeness whether or not it decoded). The decision
    margin follows AprilTag3: linear white/black gray models from the
    quiet-zone ring and the border cells, per-cell thresholds, margin =
    min(mean white-side, mean black-side distance)."""
    n = quad.shape[0]
    dev = quad.device
    H = homography_from_unit_square(quad)
    cells = tag_families.GRID + 2        # 8 with border
    cs = (torch.arange(cells, dtype=torch.float32, device=dev) + 0.5) \
        / cells * 2.0 - 1.0
    gy, gx = torch.meshgrid(cs, cs, indexing="ij")        # gx[i,j] = cs[j]
    pts = torch.stack([gx, gy], dim=-1)                   # (8,8,2)
    raw = sampler(_apply_h(H, pts))                       # (N,8,8)
    vals = _sharpen_grid(raw, sharpening)

    m = 1.0 + 1.0 / cells
    ring = torch.cat([
        torch.stack([cs, torch.full_like(cs, -m)], -1),
        torch.stack([cs, torch.full_like(cs, m)], -1),
        torch.stack([torch.full_like(cs, -m), cs], -1),
        torch.stack([torch.full_like(cs, m), cs], -1),
    ])                                                    # (32,2)
    ring_v = sampler(_apply_h(H, ring))                   # (N,32)
    border_mask = torch.zeros((cells, cells), dtype=torch.bool, device=dev)
    border_mask[0, :] = True
    border_mask[-1, :] = True
    border_mask[:, 0] = True
    border_mask[:, -1] = True

    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    A = torch.stack([ring[:, 0], ring[:, 1], torch.ones_like(ring[:, 0])],
                    dim=1)                                # (32,3)
    cw = _solve_spd3(A.T @ A + 1e-4 * eye3, ring_v @ A)   # (N,3)
    border_xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    bm_flat = border_mask.reshape(-1).to(torch.float32)
    Ab = torch.stack([border_xy[:, 0], border_xy[:, 1],
                      torch.ones(cells * cells, device=dev)], dim=1)
    Aw = Ab * bm_flat[:, None]
    raw_flat = raw.reshape(n, -1)
    cb = _solve_spd3(Aw.T @ Aw + 1e-4 * eye3, (raw_flat * bm_flat) @ Aw)

    data_xy = torch.stack([gx[1:-1, 1:-1].reshape(-1),
                           gy[1:-1, 1:-1].reshape(-1)], dim=1)  # (36,2)
    Wv = cw[:, :2] @ data_xy.T + cw[:, 2:3]                     # (N,36)
    Bv = cb[:, :2] @ data_xy.T + cb[:, 2:3]
    thresh36 = 0.5 * (Wv + Bv)

    data = vals[:, 1:-1, 1:-1].reshape(n, -1)             # (N,36) row-major
    bits = data > thresh36
    diff = data - thresh36
    n_w = torch.clamp(torch.sum(bits, dim=-1), min=1)
    n_b = torch.clamp(torch.sum(~bits, dim=-1), min=1)
    white_score = torch.sum(torch.where(bits, diff, 0.0), dim=-1) / n_w
    black_score = torch.sum(torch.where(~bits, -diff, 0.0), dim=-1) / n_b
    margin = torch.minimum(white_score, black_score)

    white_ref = torch.mean(ring_v, dim=-1)
    # the reference divides by the constant border-cell count, which XLA
    # folds into a multiply by its f32 reciprocal (probed)
    inv_border = 1.0 / (4 * (cells - 1))
    black_ref = torch.sum(raw_flat * bm_flat, dim=-1) * inv_border
    contrast_ok = (white_ref - black_ref) > 10.0
    thresh_border = 0.5 * (white_ref + black_ref)
    dark_border = border_mask & (raw < thresh_border[:, None, None])
    border_frac = torch.sum(dark_border, dim=(-2, -1)) * inv_border

    rbits = bits[:, perms]                                # (N,4,36)
    dist = torch.sum(rbits[:, :, None, :] != table[None, None], dim=-1)
    flat = torch.argmin(dist.reshape(n, -1), dim=-1)
    k = flat // table.shape[0]
    tag_id = flat % table.shape[0]
    ham = torch.gather(dist.reshape(n, -1), 1, flat[:, None])[:, 0]

    ok = (ham <= max_hamming) & contrast_ok & (border_frac > 0.7)
    # canonical corner order: the canonical TL cell appears at observed
    # corner k, so roll corners so slot 0 is the canonical TL
    roll_idx = (torch.arange(4, device=dev) + k[:, None]) % 4
    corners = _gather_last2(quad, roll_idx)
    tagness = (torch.clamp(border_frac - 0.5, min=0.0)
               * torch.clamp(white_ref - black_ref, 0.0, 100.0)
               * torch.clamp(36.0 - ham.to(torch.float32), min=0.0))
    return (torch.where(ok, tag_id, -1).to(torch.int32), k.to(torch.int32),
            ham.to(torch.int32), torch.where(ok, margin, 0.0), corners,
            tagness)


def _refine_pyramid(gray: torch.Tensor, ph: int, pw: int):
    """The bf16 row-concatenated refine pyramid of (B,h,w) gray images:
    level blocks edge-padded to a ROW_TILE multiple with >= ROW_TILE rows
    of slack, so an aligned window never crosses into the next level's
    rows. Returns (pyr (B,Hp,w) bf16, row_off (L,) int32 first row of
    each level, [(hl, wl)] each level's size)."""
    h, w = gray.shape[-2:]
    cover = min(ph, pw) - 2 * _MARGIN
    n_levels = 1
    while cover * 2 ** (n_levels - 1) < max(h, w) and n_levels < 4 \
            and (min(h, w) >> n_levels) >= 8:
        n_levels += 1
    lvl_imgs = [gray]
    for _ in range(1, n_levels):
        lvl_imgs.append(decimate(lvl_imgs[-1], 2))
    row_off, rows = [], []
    for a in lvl_imgs:
        hl_, wl_ = a.shape[-2:]
        row_off.append(sum(r.shape[1] for r in rows))
        hb = -(-(max(hl_, ph) + ROW_TILE) // ROW_TILE) * ROW_TILE
        rows.append(F.pad(a[:, None], (0, w - wl_, 0, hb - hl_),
                          mode="replicate")[:, 0].to(torch.bfloat16))
    pyr = torch.cat(rows, dim=1)                          # (B,Hp,W) bf16
    return (pyr, const(tuple(row_off), torch.int32, gray.device),
            [tuple(a.shape[-2:]) for a in lvl_imgs])


def _candidate_patches(pyr: torch.Tensor, row_off: torch.Tensor, sizes,
                       quads: torch.Tensor, ph: int, pw: int):
    """Each candidate's (B,C,4,2) full-resolution quad gets the window of
    the finest pyramid level whose (ph,pw) cover holds it with _MARGIN px
    to spare (quads bigger than the deepest level's cover decode from the
    deepest window without refinement). Returns (patches (B,C,AH,AW),
    off (B,C,1,2) each window's origin in level pixels, scale (B,C,1,1)
    each level's scale, fits (B,C))."""
    qlo = torch.amin(quads, dim=-2)                       # (B,C,2) x,y
    qhi = torch.amax(quads, dim=-2)
    starts_l, fits_l = [], []
    for lv, (hl_, wl_) in enumerate(sizes):
        s = 2 ** lv
        lo_l = (qlo - (s - 1) / 2.0) / s
        hi_l = (qhi - (s - 1) / 2.0) / s
        starts_l.append(torch.stack([
            torch.clamp(torch.floor(lo_l[..., 0] - _MARGIN).to(torch.int32),
                        0, max(wl_ - pw, 0)),
            torch.clamp(torch.floor(lo_l[..., 1] - _MARGIN).to(torch.int32),
                        0, max(hl_ - ph, 0))], dim=-1))
        fits_l.append(((hi_l[..., 0] - lo_l[..., 0]) <= pw - 2 * _MARGIN)
                      & ((hi_l[..., 1] - lo_l[..., 1]) <= ph - 2 * _MARGIN))
    fits_all = torch.stack(fits_l, dim=-1)                # (B,C,L)
    fits = torch.any(fits_all, dim=-1)
    lvl = torch.where(fits, torch.argmax(fits_all.to(torch.int32), dim=-1),
                      len(sizes) - 1)
    starts = _gather_last2(torch.stack(starts_l, dim=-2), lvl[..., None])[
        ..., 0, :]
    scale = torch.exp2(lvl.to(torch.float32))[..., None, None]  # (B,C,1,1)
    patches, ay, ax = extract_patches_pyramid(
        pyr, row_off[lvl] + starts[..., 1], starts[..., 0], ph, pw)
    off = torch.stack([ax, ay - row_off[lvl]],
                      dim=-1).to(torch.float32)[..., None, :]   # (B,C,1,2)
    return patches, off, scale, fits


def detect_tags(img: torch.Tensor,
                config: DetectorConfig = DetectorConfig(),
                with_candidates: bool = False):
    """Detect tag36h11 tags in a batch of images: (B,H,W,3) uint8 RGB or
    (B,H,W) gray. Returns fixed-capacity ``Detections``
    (config.max_detections slots per frame).

    With `with_candidates`, returns (Detections, cand_bbox (B,C,4) f32
    [xmin,ymin,xmax,ymax] of every refined candidate quad at full
    resolution, cand_score (B,C) f32 tag-likeness, 0 for dead slots and
    for quads over 192 px, which decode well decimated)."""
    gray = rgb_to_gray(img) if img.ndim == 4 else img.to(torch.float32)
    if config.quad_sigma > 0:
        gray = gaussian_blur(gray, config.quad_sigma)
    B, h, w = gray.shape
    dev = gray.device

    # segmentation and quad search run decimated; corners are refined at
    # full resolution afterwards
    dec = max(1, int(config.quad_decimate))
    gray_lo = decimate(gray, dec) if dec > 1 else gray
    hl, wl = gray_lo.shape[-2:]

    binary, ambiguous = adaptive_threshold(gray_lo, tile=config.tile,
                                           min_contrast=config.min_contrast)
    dark = (~binary) & (~ambiguous)
    labels = connected_components(dark, iters=config.ccl_iters,
                                  converge=True)
    roots, areas, valid_c, bbox = top_k_components(
        labels, config.max_components,
        min_area=config.min_area_px / (dec * dec),
        max_area=config.max_area_frac * hl * wl, ring_filter=True,
        min_side=8.0 / dec, return_bbox=True)
    areas = areas * (dec * dec)

    sup = _support_points(labels, roots, bbox)            # (B,C,16,2)
    quads = _quad_from_support(sup)                       # (B,C,4,2)
    if dec > 1:
        # low-res pixel i covers full-res [i*dec, i*dec+dec-1]
        quads = quads * dec + (dec - 1) / 2.0

    ph, pw = min(_PATCH, h), min(_PATCH, w)
    pyr, row_off, sizes = _refine_pyramid(gray, ph, pw)
    patches, off, scale, fits = _candidate_patches(pyr, row_off, sizes,
                                                   quads, ph, pw)
    q_rel = (quads - (scale - 1) / 2.0) / scale - off

    C = quads.shape[1]
    n = B * C
    flat_patches = patches.reshape(n, *patches.shape[2:])
    # pass 1 scans +-(2+dec) px at 1 px steps; pass 2 +-1 px at 1/4 px
    q_ref = _refine_edges(flat_patches, q_rel.reshape(n, 4, 2),
                          search=2.0 + dec, offset_step=1.0)
    q_ref = _refine_edges(flat_patches, q_ref, search=1.0, offset_step=0.25)
    q_rel = torch.where(fits[..., None, None], q_ref.reshape(B, C, 4, 2),
                        q_rel)
    quads = (q_rel + off) * scale + (scale - 1) / 2.0

    table, perms = pin(_decode_tables(dev))
    sc = scale.reshape(n, 1, 1)
    off_n = off.reshape(n, 1, 2)

    def sampler(pts_full):
        p = pts_full.reshape(n, -1, 2)
        out = bilinear_sample_patch(flat_patches,
                                    (p - (sc - 1.0) / 2.0) / sc - off_n)
        return out.reshape(pts_full.shape[:-1])

    ids, _, hams, margins, corners, tagness = _decode_quad(
        quads.reshape(n, 4, 2), table, perms, config.decode_sharpening,
        config.max_hamming, sampler)
    ids, hams, margins, tagness = (x.reshape(B, C) for x in
                                   (ids, hams, margins, tagness))
    corners = corners.reshape(B, C, 4, 2)

    # quad sanity: distinct corners
    e = torch.linalg.vector_norm(corners - torch.roll(corners, 1, dims=-2),
                                 dim=-1)
    sane = torch.amin(e, dim=-1) > 2.0
    ok = valid_c & (ids >= 0) & sane & (margins >= config.min_decision_margin)

    # compact: top-D by decision margin (ties toward the lower slot)
    D = config.max_detections
    top_scores, top_idx = top_k_stable(torch.where(ok, margins, -1.0), D)
    sel_valid = top_scores > 0
    sel_corners = _gather_last2(corners.reshape(B, C, 8), top_idx).reshape(
        B, D, 4, 2)
    det = Detections(
        ids=torch.where(sel_valid, torch.gather(ids, 1, top_idx), -1),
        corners=sel_corners,
        centers=torch.mean(sel_corners, dim=-2),
        decision_margin=torch.where(sel_valid,
                                    torch.gather(margins, 1, top_idx), 0.0),
        hamming=torch.gather(hams, 1, top_idx),
        areas=torch.gather(areas, 1, top_idx),
        valid=sel_valid,
    )
    if with_candidates:
        cand_bbox = torch.cat([torch.amin(quads, dim=-2),
                               torch.amax(quads, dim=-2)], dim=-1)
        side = torch.amax(cand_bbox[..., 2:] - cand_bbox[..., :2], dim=-1)
        cand_score = torch.where(valid_c & sane & (side <= 192.0), tagness,
                                 0.0)
        return det, cand_bbox, cand_score
    return det


detect_tags_jit = jit(detect_tags, static_argnames=("config",
                                                    "with_candidates"))


def detect_tags_batch(imgs: torch.Tensor,
                      config: DetectorConfig = DetectorConfig()) -> Detections:
    """Detector over a frame batch (N,H,W[,3]): the reference's vmapped
    ``detect_tags``; the port's ``detect_tags`` is batched already."""
    return detect_tags(imgs, config)
