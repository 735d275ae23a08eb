"""Robust detection retry ladder.

Port of ``repas_tpu/detect/robust.py`` (``_merge_by_margin``,
``_enhance_stack``, ``detect_tags_robust``, ``_top_rois``, ``_stage_a``,
``_stage_b``, ``_stage_c``, ``detect_tags_robust_staged``). Hard frames
are retried over enhancement and parameter variants (CLAHE, blur, gamma,
full resolution) and the detections merge by decision margin.
``jax.vmap`` becomes a written-out frame dimension: every function works
on (N, ...) tensors.

The staged ladder keeps the reference's waves: stages B and C each pick
``_ESC_K`` frames per wave on the device (top-k over "not found and not
attempted") until every frame that needs the tier has had it. The
reference runs the waves in ``lax.while_loop``; here they run in
``core.jit.while_loop``, bounded by ceil(N / k) trips: a wave attempts
k frames that were neither found nor attempted, or all that are left,
and a frame once found or attempted stays so.

The reference's jitted pieces are compiled steps here (``core.jit``: a
CUDA graph per static configuration on the card, the function itself on
the CPU; the plain function is each step's ``.fn``): stages A, B and C,
and ``detect_tags_robust``'s variant stack, batched detect and merge.
Captured, the wave loops are conditional graph nodes, so a replayed
ladder reads nothing on the host. Run eagerly (the capture's warm-up, or
the ``.fn`` functions), the loop condition is read on the host once per
wave test and counted in ``host_reads``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repas_tpu_torch.core.config import DetectorConfig
from repas_tpu_torch.core.jit import jit, while_loop
from repas_tpu_torch.detect.detector import Detections, detect_tags
from repas_tpu_torch.kernels.ccl import top_k_stable
from repas_tpu_torch.kernels.image import (clahe, gamma_lut, gaussian_blur,
                                           rgb_to_gray)

# ROI escalation geometry: 256^2 windows around candidate quads cover any
# tag small enough to have been hurt by decimation
_ROI = 256
_ROI_Q = 4          # candidate windows re-examined per escalated frame
_ESC_K = 2          # frames escalated per wave

# Host reads of the wave loops' condition in an eager ladder, its only
# device reads (one per wave test); callers may reset it.
host_reads = {"wave_tests": 0}


def _flat(d: Detections, n: int) -> Detections:
    """Detections with any slot dims after the frame dim folded into one."""
    return Detections(
        ids=d.ids.reshape(n, -1), corners=d.corners.reshape(n, -1, 4, 2),
        centers=d.centers.reshape(n, -1, 2),
        decision_margin=d.decision_margin.reshape(n, -1),
        hamming=d.hamming.reshape(n, -1), areas=d.areas.reshape(n, -1),
        valid=d.valid.reshape(n, -1))


def _merge_by_margin(dets: list, D: int) -> Detections:
    """Per frame: concatenate detection sets (each (N, ...slots)), dedupe
    by (id, centre within half the larger component side, at least 4 px)
    keeping the higher margin, return the top-D slots (N,D)."""
    n = dets[0].ids.shape[0]
    parts = [_flat(d, n) for d in dets]
    ids = torch.cat([d.ids for d in parts], dim=1)
    margins = torch.cat([torch.where(d.valid, d.decision_margin, -1.0)
                         for d in parts], dim=1)
    corners = torch.cat([d.corners for d in parts], dim=1)
    centers = torch.cat([d.centers for d in parts], dim=1)
    hams = torch.cat([d.hamming for d in parts], dim=1)
    areas = torch.cat([d.areas for d in parts], dim=1)

    order = torch.argsort(-margins, dim=1, stable=True)
    ids_sorted = torch.gather(ids, 1, order)
    c_sorted = torch.gather(centers, 1, order[..., None].expand(-1, -1, 2))
    side = torch.sqrt(torch.clamp(torch.gather(areas, 1, order), min=0.0))
    rad = torch.clamp(torch.maximum(side[:, :, None], side[:, None, :]) * 0.5,
                      min=4.0)
    d2 = torch.sum((c_sorted[:, :, None, :] - c_sorted[:, None, :, :]) ** 2,
                   dim=-1)
    same = ((ids_sorted[:, :, None] == ids_sorted[:, None, :])
            & (d2 < rad * rad))
    earlier = torch.tril(same, diagonal=-1).any(dim=2)
    keep_sorted = (~earlier) & (torch.gather(margins, 1, order) > 0)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)

    score = torch.where(keep, margins, -1.0)
    top_scores, top_idx = top_k_stable(score, D)
    sel = top_scores > 0
    return Detections(
        ids=torch.where(sel, torch.gather(ids, 1, top_idx), -1),
        corners=torch.gather(corners, 1,
                             top_idx[..., None, None].expand(-1, -1, 4, 2)),
        centers=torch.gather(centers, 1, top_idx[..., None].expand(-1, -1, 2)),
        decision_margin=torch.where(sel, torch.gather(margins, 1, top_idx),
                                    0.0),
        hamming=torch.gather(hams, 1, top_idx),
        areas=torch.gather(areas, 1, top_idx),
        valid=sel,
    )


def _gray(img: torch.Tensor, rgb: bool) -> torch.Tensor:
    return rgb_to_gray(img) if rgb else img.to(torch.float32)


@functools.partial(jit, static_argnames=("use_clahe", "use_gamma", "gamma"))
def _enhance_stack(img: torch.Tensor, use_clahe: bool, use_gamma: bool,
                   gamma: float):
    """Variant stack (V,H,W) of one image + its (gray, clahe)."""
    gray = _gray(img, img.ndim == 3)
    cl = clahe(gray) if use_clahe else gray
    variants = [gray, gaussian_blur(gray, 1.0)]
    if use_clahe:
        variants.append(cl)
    if use_gamma:
        variants.append(gamma_lut(gray, gamma))
    return torch.stack(variants), gray, cl


def _stacked(det: Detections) -> Detections:
    """(V,D) detections of one image's variants as one frame (1,V,D)."""
    return Detections(*(x[None] for x in det))


def _one(det: Detections) -> Detections:
    return Detections(*(x[0] for x in det))


@functools.partial(jit, static_argnames=("config",))
def _detect_batch(batch: torch.Tensor, config: DetectorConfig) -> Detections:
    """One image's variant stack (V,H,W) detected as one frame: (1,V,D)."""
    return _stacked(detect_tags(batch, config))


@functools.partial(jit, static_argnames=("D",))
def _merge_jit(dets: list, D: int) -> Detections:
    return _merge_by_margin(dets, D)


def detect_tags_robust(img: torch.Tensor,
                       config: DetectorConfig = DetectorConfig(),
                       use_clahe: bool = True, use_gamma: bool = True,
                       full_res_pass: bool = True,
                       gamma: float = 0.7) -> Detections:
    """Detect in ONE image (H,W[,3]) over [raw, blurred, CLAHE, gamma]
    variants, plus a decimate-1 pass over [raw, CLAHE] when config
    decimates, and merge by decision margin. Returns (D,) slots."""
    batch, gray, cl = _enhance_stack(img, use_clahe, use_gamma, gamma)
    dets = [_detect_batch(batch, config)]
    if full_res_pass and config.quad_decimate > 1:
        cfg1 = dataclasses.replace(config, quad_decimate=1.0)
        dets.append(_detect_batch(torch.stack([gray, cl]), cfg1))
    return _one(_merge_jit(dets, config.max_detections))


def _top_rois(bbox: torch.Tensor, score: torch.Tensor, q: int):
    """Per frame, greedy centre-proximity NMS over candidate bboxes
    (N,C,4) / scores (N,C), then the top-q: (boxes (N,q,4), scores (N,q)).
    A lower-score candidate whose centre lies within half the larger
    bbox diagonal of an earlier one is suppressed."""
    order = torch.argsort(-score, dim=1, stable=True)
    b = torch.gather(bbox, 1, order[..., None].expand(-1, -1, 4))
    s = torch.gather(score, 1, order)
    c = 0.5 * (b[..., :2] + b[..., 2:])
    diag = torch.linalg.vector_norm(b[..., 2:] - b[..., :2], dim=-1)
    rad = torch.maximum(diag[:, :, None], diag[:, None, :]) * 0.5
    d2 = torch.sum((c[:, :, None, :] - c[:, None, :, :]) ** 2, dim=-1)
    sup = torch.tril(d2 < rad * rad, diagonal=-1).any(dim=2)
    s = torch.where(sup, 0.0, s)
    top_s, qi = top_k_stable(s, q)
    return torch.gather(b, 1, qi[..., None].expand(-1, -1, 4)), top_s


@functools.partial(jit, static_argnames=("config",))
def _stage_a(frames: torch.Tensor, config: DetectorConfig):
    """Stage A: CLAHE decimated sweep on every frame -> (Detections,
    found (N,), grays (N,H,W), top-Q candidate ROIs (N,Q,4), their
    tag-likeness scores (N,Q))."""
    grays = _gray(frames, frames.ndim == 4)
    det, bbox, score = detect_tags(clahe(grays), config, with_candidates=True)
    rois, rscores = _top_rois(bbox, score, _ROI_Q)
    return det, det.valid.any(dim=1), grays, rois, rscores


def _live(d: Detections, ok: torch.Tensor) -> Detections:
    """Slots of attempts that did not run for real (ok False) invalid."""
    return d._replace(ids=torch.where(ok, d.ids, -1),
                      decision_margin=torch.where(ok, d.decision_margin, 0.0),
                      valid=d.valid & ok)


def _index(d: Detections, idx: torch.Tensor) -> Detections:
    return Detections(*(x[idx] for x in d))


def _scatter(d: Detections, idx: torch.Tensor, m: Detections) -> Detections:
    out = []
    for x, y in zip(d, m):
        x = x.clone()
        x[idx] = y
        out.append(x)
    return Detections(*out)


def _select_b(done, rscores, k):
    """Stage B's wave: the k frames neither found nor attempted with the
    strongest candidate evidence first, done frames last."""
    sel_score = torch.where(done, -1.0, 1.0 + torch.amax(rscores, dim=1))
    return top_k_stable(sel_score, k)[1]


def _select_c(done, k):
    """Stage C's wave: the first k frames neither found nor attempted."""
    return top_k_stable(torch.where(done, -1.0, 1.0), k)[1]


def _count_wave_test():
    host_reads["wave_tests"] += 1


def _waves(det, found, select, escalate, D):
    """Run waves of k = min(_ESC_K, N) frames until every frame is found
    or has been attempted: select(done) -> frame indices (k,),
    escalate(idx, live) -> (k,D) detections merged into those frames.
    The reference's lax.while_loop, at most ceil(N / k) waves."""
    n = found.shape[0]
    k = min(_ESC_K, n)

    def pending(state):
        _, found, attempted = state
        return torch.any(~found & ~attempted)

    def wave(state):
        det, found, attempted = state
        done = found | attempted
        sel_idx = select(done)
        sel_live = ~done[sel_idx]
        det_esc = escalate(sel_idx, sel_live)
        merged = _merge_by_margin([_index(det, sel_idx), det_esc], D)
        det = _scatter(det, sel_idx, merged)
        attempted = attempted.index_put((sel_idx,),
                                        attempted[sel_idx] | sel_live)
        return det, det.valid.any(dim=1), attempted

    det, found, _ = while_loop(pending, wave,
                               (det, found, torch.zeros_like(found)),
                               max_trips=-(-n // k),
                               on_test=_count_wave_test)
    return det, found


@functools.partial(jit, static_argnames=("config",))
def _stage_b(grays, det: Detections, found, rois, rscores,
             config: DetectorConfig):
    """Stage B: full-resolution [raw, CLAHE] re-detection on the top-Q
    candidate ROIs of frames stage A left empty -> (Detections, found)."""
    cfg_roi = dataclasses.replace(config, quad_decimate=1.0,
                                  max_components=16, max_detections=4)
    D = config.max_detections
    n, h, w = grays.shape
    k = min(_ESC_K, n)
    r = min(_ROI, h, w)
    dev = grays.device
    ar = torch.arange(r, device=dev)

    def select(done):
        return _select_b(done, rscores, k)

    def escalate(sel_idx, sel_live):
        boxes, scores = rois[sel_idx], rscores[sel_idx]          # (k,Q,...)
        ctr = 0.5 * (boxes[..., :2] + boxes[..., 2:])
        start = torch.round(ctr - r / 2).to(torch.int32)
        sx = torch.clamp(start[..., 0], 0, max(w - r, 0)).to(torch.int64)
        sy = torch.clamp(start[..., 1], 0, max(h - r, 0)).to(torch.int64)
        g = grays[sel_idx]                                       # (k,H,W)
        fi = torch.arange(k, device=dev)[:, None, None, None]
        roi = g[fi, (sy[..., None] + ar)[..., None],
                (sx[..., None] + ar)[..., None, :]]              # (k,Q,r,r)
        q = roi.shape[1]
        batch = torch.stack([roi, clahe(roi)], dim=2)           # (k,Q,2,r,r)
        d = detect_tags(batch.reshape(-1, r, r), cfg_roi)
        d = Detections(*(x.reshape(k, q, 2, *x.shape[1:]) for x in d))
        ok = (sel_live[:, None] & (scores > 0))[..., None, None]  # (k,Q,1,1)
        off = torch.stack([sx, sy], dim=-1).to(torch.float32)[:, :, None,
                                                              None, :]
        d = _live(d, ok)._replace(
            corners=d.corners + off[..., None, :],
            centers=d.centers + off)
        return _merge_by_margin([d], D)

    return _waves(det, found, select, escalate, D)


@functools.partial(jit, static_argnames=("config",))
def _stage_c(grays, det: Detections, found, config: DetectorConfig):
    """Stage C: whole-frame full-resolution [raw, CLAHE] sweep on frames
    still empty after stage B."""
    cfg1 = dataclasses.replace(config, quad_decimate=1.0)
    D = config.max_detections
    k = min(_ESC_K, grays.shape[0])

    def select(done):
        return _select_c(done, k)

    def escalate(sel_idx, sel_live):
        g = grays[sel_idx]
        batch = torch.stack([g, clahe(g)], dim=1)               # (k,2,H,W)
        d = detect_tags(batch.reshape(-1, *g.shape[1:]), cfg1)
        d = Detections(*(x.reshape(k, 2, *x.shape[1:]) for x in d))
        return _merge_by_margin([_live(d, sel_live[:, None, None])], D)

    return _waves(det, found, select, escalate, D)[0]


def detect_tags_robust_staged(frames: torch.Tensor,
                              config: DetectorConfig = DetectorConfig(),
                              gamma: float = 0.7) -> Detections:
    """Escalation ladder over a frame batch (N,H,W[,3]) -> (N,D) slots.

      A. CLAHE decimated sweep on every frame, which also yields each
         frame's top-Q candidate ROIs, decoded or not;
      B. [raw, CLAHE] full-resolution re-detection on those ROIs, for
         frames with no accepted tag (decimation can destroy a small
         tag's decode while its quad survives);
      C. [raw, CLAHE] whole-frame full-resolution sweep on frames still
         empty (no decimated candidate at all).

    Escalated frames merge all stages' detections by decision margin.
    `gamma` is kept for the reference's signature; the staged ladder runs
    no gamma variant.
    """
    del gamma
    det, found, grays, rois, rscores = _stage_a(frames, config)
    if config.quad_decimate > 1:
        det, found = _stage_b(grays, det, found, rois, rscores, config)
        det = _stage_c(grays, det, found, config)
    return det
