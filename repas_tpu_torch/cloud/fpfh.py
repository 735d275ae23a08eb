"""FPFH features and batched-RANSAC global registration.

Port of ``repas_tpu/cloud/fpfh.py`` (Open3D compute_fpfh_feature +
registration_ransac_based_on_feature_matching):

  * FPFH: per-point SPFH (Darboux-frame angle histograms, 11 bins per
    angle = 33 dims) over the k nearest neighbours, then the
    neighbour-weighted sum. Neighbours from the grid-hash k-NN.
  * Matching: feature-distance matmuls and argmin, chunked over source
    rows so the (N,M) distance matrix never exists whole.
  * RANSAC: all 3-point hypotheses at once: one batched Kabsch solve
    (kernel K2, ``kernels/kabsch3.py``, on the card; ``torch.linalg.svd``
    on the CPU), edge-length and distance checkers, inlier counts.

``fpfh_features``, ``match_features`` and RANSAC's scoring step are
compiled on the card (``core.jit``, as the reference jits them), with
the reference's static arguments and the radius and thresholds as 0-d
tensors. ``ransac_registration`` draws its hypotheses before its step,
from a seeded ``torch.Generator``, which a graph could not reseed (the
reference's step takes its PRNG key as an input, the same split).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repas_tpu_torch.cloud.filters import _choice, _generator
from repas_tpu_torch.cloud.knn import _chunks, _sqnorm, knn_neighbors
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.core.transforms import make_T
from repas_tpu_torch.kernels.kabsch3 import kabsch3

_THIRD = float(np.float32(1.0) / np.float32(3.0))


def _hist(x: torch.Tensor, within: torch.Tensor, lo: float, hi: float,
          bins: int) -> torch.Tensor:
    """(C,bins) counts of x (C,k) over [lo, hi) where `within`. XLA folds
    the reference's (x - lo) / (hi - lo) * bins into one multiply by
    float32(1 / (hi - lo)) * bins, both rounded to float32; so here, or a
    value on a bin edge changes bin. Clamped in float before the integer
    conversion, which truncates as XLA's does."""
    scale = float(np.float32(np.float32(1.0) / np.float32(hi - lo))
                  * np.float32(bins))
    f = torch.clamp((x - lo) * scale, 0.0, bins - 1.0)
    b = torch.clamp(f.to(torch.int64), 0, bins - 1)
    out = torch.zeros(x.shape[0], bins, dtype=torch.float32, device=x.device)
    return out.scatter_add_(1, b, within.to(torch.float32))


@functools.partial(jit, static_argnames=("k", "bins", "dims", "slots",
                                         "chunk"),
                   scalar_argnames=("radius",))
def fpfh_features(pts: torch.Tensor, normals: torch.Tensor,
                  mask: torch.Tensor, radius: float,
                  k: int = 32, bins: int = 11,
                  dims: tuple = (48, 48, 48), slots: int = 48,
                  chunk: int = 65536) -> torch.Tensor:
    """(N, 3*bins) FPFH descriptors (zero rows where mask is False).

    Neighbourhoods come from the grid-hash k-NN over the full cloud. The
    SPFH pass and the neighbour-weighted sum run in chunks of `chunk`
    points, so peak memory is O(chunk * k * bins) at any cloud size."""
    idx, dist = knn_neighbors(pts, mask, radius, k + 1, dims=dims,
                              slots=slots)
    nn = torch.clamp(idx[:, 1:], min=0).to(torch.int64)   # drop self
    dist = dist[:, 1:]
    within = (dist <= radius) & (idx[:, 1:] >= 0)
    d = torch.where(within, dist, 1.0) + 1e-12
    n = pts.shape[0]
    spfh = torch.empty(n, 3 * bins, dtype=torch.float32, device=pts.device)
    cnt = torch.empty(n, dtype=torch.float32, device=pts.device)
    for s, e in _chunks(n, chunk):
        w_c = within[s:e]
        p1 = pts[s:e, None, :]
        u = normals[s:e, None, :].expand(-1, nn.shape[1], -1)
        n2 = normals[nn[s:e]]
        d_hat = (pts[nn[s:e]] - p1) / d[s:e, :, None]
        # Darboux frame (u, v, w) at the source point
        v = torch.linalg.cross(d_hat, u, dim=-1)
        v = v / (torch.sqrt(_sqnorm(v))[..., None] + 1e-12)
        w = torch.linalg.cross(u, v, dim=-1)
        alpha = torch.sum(v * n2, dim=-1)
        phi = torch.sum(u * d_hat, dim=-1)
        theta = torch.arctan2(torch.sum(w * n2, dim=-1),
                              torch.sum(u * n2, dim=-1))
        c = torch.clamp(torch.sum(w_c, dim=1).to(torch.float32), min=1.0)
        h = torch.cat([_hist(alpha, w_c, -1.0, 1.0, bins),
                       _hist(phi, w_c, -1.0, 1.0, bins),
                       _hist(theta, w_c, -math.pi, math.pi, bins)], dim=1)
        spfh[s:e] = h / c[:, None]
        cnt[s:e] = c

    # FPFH = SPFH(p) + (1/cnt) sum_j SPFH(j) / dist_j over the true
    # neighbours
    fpfh = torch.empty_like(spfh)
    for s, e in _chunks(n, chunk):
        wgt = torch.where(within[s:e], 1.0 / d[s:e], 0.0)
        fpfh[s:e] = spfh[s:e] + torch.einsum(
            "nk,nkf->nf", wgt, spfh[nn[s:e]]) / cnt[s:e, None]
    return torch.where(mask[:, None], fpfh, 0.0)


@functools.partial(jit, static_argnames=("chunk",))
def match_features(feat_src: torch.Tensor, src_mask: torch.Tensor,
                   feat_tgt: torch.Tensor, tgt_mask: torch.Tensor,
                   chunk: int = 1024):
    """Nearest-neighbour feature correspondence src -> tgt, `chunk` source
    rows at a time (full-f32 matmuls: the package sets no TF32). Ties go
    to the lower target index. Returns (idx (N,) int32, dist (N,))."""
    n = feat_src.shape[0]
    tgt_sq = torch.sum(feat_tgt * feat_tgt, dim=1)
    j = torch.empty(n, dtype=torch.int32, device=feat_src.device)
    dmin = torch.empty(n, dtype=torch.float32, device=feat_src.device)
    for s, e in _chunks(n, chunk):
        f = feat_src[s:e]
        d2 = (torch.sum(f * f, dim=1, keepdim=True)
              - (2.0 * f) @ feat_tgt.T + tgt_sq[None, :])
        d2 = torch.where(tgt_mask[None, :], d2, torch.inf)
        jj = torch.argmin(d2, dim=1, keepdim=True)
        j[s:e] = jj[:, 0].to(torch.int32)
        dmin[s:e] = torch.gather(d2, 1, jj)[:, 0]
    return (torch.where(src_mask, j, -1),
            torch.where(src_mask, dmin, torch.inf))


def _kabsch(P: torch.Tensor, Q: torch.Tensor):
    """Rigid transforms aligning point triples P (...,3,3) onto Q from the
    SVD of their cross-covariance H (``kernels.kabsch3``: kernel K2 on the
    card, one batched torch.linalg.svd on the CPU). The centroids are
    XLA's mean: a sum in order times float32(1/3). Returns (R (...,3,3),
    t (...,3))."""
    cp = ((P[..., 0, :] + P[..., 1, :]) + P[..., 2, :]) * _THIRD
    cq = ((Q[..., 0, :] + Q[..., 1, :]) + Q[..., 2, :]) * _THIRD
    H = (P - cp[..., None, :]).mT @ (Q - cq[..., None, :])
    R = kabsch3(H.reshape(-1, 3, 3)).reshape(H.shape)
    t = cq - (R @ cp[..., None])[..., 0]
    return R, t


@functools.partial(jit, scalar_argnames=("dist_thresh", "edge_check"))
def _ransac_from_picks(src, src_mask, tgt, tgt_mask, corr, dist_thresh,
                       edge_check, picks, ev):
    """ransac_registration's scoring of the hypotheses `picks` (H,3) on
    the evaluation points `ev` (E,). Returns (T (4,4), fitness, scores
    (H,) int, best (1,)): the first hypothesis of the highest score wins,
    as jnp.argmax picks it."""
    ok = src_mask & (corr >= 0)
    corr_s = torch.clamp(corr, min=0).to(torch.int64)
    ev_src = src[ev]
    ev_tgt = tgt[corr_s[ev]]
    ev_ok = ok[ev]
    P = src[picks]                                   # (H,3,3)
    Q = tgt[corr_s[picks]]
    # edge-length checker
    eP = torch.sqrt(_sqnorm(P - torch.roll(P, 1, dims=-2)))
    eQ = torch.sqrt(_sqnorm(Q - torch.roll(Q, 1, dims=-2)))
    ratio = torch.minimum(eP, eQ) / torch.clamp(torch.maximum(eP, eQ),
                                                min=1e-12)
    edges_ok = torch.all(ratio > edge_check, dim=-1)
    R, t = _kabsch(P, Q)
    res = ev_src[None] @ R.mT + t[:, None, :] - ev_tgt[None]
    inl = (torch.sqrt(_sqnorm(res)) <= dist_thresh) & ev_ok[None]
    scores = torch.where(edges_ok, torch.sum(inl, dim=1), -1)
    best = torch.argmax(scores).reshape(1)
    T = make_T(R.index_select(0, best)[0], t.index_select(0, best)[0])
    fitness = (scores.index_select(0, best)[0]
               / torch.clamp(torch.sum(ev_ok), min=1))
    return T, fitness, scores, best


def ransac_registration(src: torch.Tensor, src_mask: torch.Tensor,
                        tgt: torch.Tensor, tgt_mask: torch.Tensor,
                        corr: torch.Tensor,
                        dist_thresh: float,
                        edge_check: float = 0.9,
                        n_hypotheses: int = 8192,
                        eval_points: int = 2048,
                        key: int | None = None):
    """Batched 3-point RANSAC over precomputed correspondences.

    corr (N,) maps src index -> tgt index (-1 invalid). Checkers mirror
    Open3D: edge-length similarity > edge_check, correspondence distance
    <= dist_thresh. The picks and evaluation points are drawn with
    replacement from the valid correspondences by a generator seeded by
    `key` (default 3). Returns (T (4,4), fitness)."""
    ok = src_mask & (corr >= 0)
    gen = _generator(src.device, 3 if key is None else key)
    picks = _choice(ok, 3 * n_hypotheses, True, gen).reshape(n_hypotheses, 3)
    ev = _choice(ok, eval_points, True, gen)
    T, fitness, _, _ = _ransac_from_picks(src, src_mask, tgt, tgt_mask, corr,
                                          dist_thresh, edge_check, picks, ev)
    return T, fitness

