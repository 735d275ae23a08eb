"""Temporal register-then-track pose streaming.

Port of ``repas_tpu/pose/track.py`` (``TrackerConfig``, ``TrackResult``,
``_roi_detector_config``, ``_track_roi``, ``TagTracker``):

  register : full-frame detection (optionally the robust ladder) and
             IPPE-square on the best decoded tag.
  track    : a fixed-size ROI around the tag center predicted from the
             previous pose; the detector runs on the ROI alone (no
             decimation) and the previous (rvec, t) is LM-refined on the
             matching tag's corners (their order is pinned by decode).
  recovery : a miss keeps the prior for up to `max_misses` frames, then
             the tracker registers again on the full frame.

Each step waits for the device once: a register step reads the chosen
slot, id, pose and error in one transfer, a track step reads found,
error, pose and the held prior's rotation in one transfer and keeps a
host copy of t for the next ROI. Host frames, and the ROI's origin and
tag id, are copied to the device without waiting for it.

``TagTracker`` holds its steps compiled (``core/jit.py``, the
counterpart of the reference's ``jax.jit``), shared by every tracker:
``_track_roi``, with the ROI origin and tag id as device tensors, and
the register step's ``detect_tags`` at the frame's shape and
``solve_pnp_ippe_square``. On the card each is a CUDA graph captured at
its first call for a shape and configuration and replayed; the host
read of each step stays outside the graphs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repas_tpu_torch.core.config import DetectorConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.core.transforms import rodrigues, rodrigues_inv
from repas_tpu_torch.detect.detector import detect_tags
from repas_tpu_torch.pose.pnp import (refine_pnp_gn, solve_pnp_ippe_square,
                                      square_object_points)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    roi: int = 256                 # ROI side in px (static shape)
    max_misses: int = 3            # tracked-mode failures before re-register
    max_err_px: float = 3.0        # LM reprojection gate to accept a track
    min_margin: float = 10.0       # decision-margin gate
    gn_iters: int = 10
    robust_register: bool = False  # use the enhancement ladder on register


class TrackResult(NamedTuple):
    ok: bool
    tag_id: int
    R: np.ndarray                  # (3,3)
    t: np.ndarray                  # (3,)
    err_px: float
    mode: str                      # "track" | "register" | "lost"


def _roi_detector_config(cfg: DetectorConfig, roi: int) -> DetectorConfig:
    """Detector sized for the ROI: no decimation (the crop is small), a
    modest component budget."""
    return dataclasses.replace(
        cfg, quad_decimate=1.0,
        max_components=min(cfg.max_components, 16),
        max_detections=min(cfg.max_detections, 4))


def _track_roi(img, u0, v0, tag_id, rvec_prev, tvec_prev, K, dist,
               tag_size: float, det_cfg: DetectorConfig, roi: int,
               min_margin: float, gn_iters: int):
    """Detect inside img[v0:v0+roi, u0:u0+roi] and LM-refine the prior on
    the best-margin slot of the wanted id (ties: the lower slot). u0, v0
    and tag_id are int32 0-dim tensors on img's device, as the reference
    traces them; the crop is a gather whose start follows
    ``jax.lax.dynamic_slice`` (clamped so the window fits). Returns
    (found, rvec, tvec, err, corners); without a match the prior and an
    infinite error."""
    h, w = img.shape[:2]
    ar = torch.arange(roi, device=img.device)
    rows = torch.clamp(v0, 0, h - roi) + ar
    cols = torch.clamp(u0, 0, w - roi) + ar
    patch = img.index_select(0, rows).index_select(1, cols)
    det = detect_tags(patch[None], det_cfg)
    match = det.valid[0] & (det.ids[0] == tag_id) & \
        (det.decision_margin[0] >= min_margin)
    # a 0-dim index tensor would be read on the host: index_select
    i = torch.argmax(torch.where(match, det.decision_margin[0], -1.0))
    found = match.any()
    c = det.corners[0].index_select(0, i.reshape(1))[0]
    corners = torch.stack([c[:, 0] + u0, c[:, 1] + v0], dim=-1)
    obj = square_object_points(tag_size, img.device)
    rvec, tvec, err = refine_pnp_gn(obj, corners, rvec_prev, tvec_prev, K,
                                    dist, iters=gn_iters)
    rvec = torch.where(found, rvec, rvec_prev)
    tvec = torch.where(found, tvec, tvec_prev)
    err = torch.where(found, err, float("inf"))
    return found, rvec, tvec, err, corners


class TagTracker:
    """Host-side streaming tracker around the register and track steps.

    Usage:
        tr = TagTracker(K, dist, tag_size=0.0303)
        for frame in stream:
            res = tr.step(frame_rgb)   # TrackResult

    Frames are (H,W,3) uint8 RGB or (H,W) gray, numpy or tensors. The
    tracker runs on `device`, by default the card (raises without one).
    """

    # the compiled steps, shared by every tracker as jax.jit's cache is:
    # on the card one CUDA graph per frame shape and configuration
    _track = jit(_track_roi, static_argnames=(
        "tag_size", "det_cfg", "roi", "min_margin", "gn_iters"))
    _detect = jit(detect_tags, static_argnames=("config", "with_candidates"))
    _ippe = jit(solve_pnp_ippe_square,
                static_argnames=("tag_size_m", "refine_iters"))

    def __init__(self, K, dist=None, tag_size: float = 0.0303,
                 config: TrackerConfig = TrackerConfig(),
                 det_cfg: DetectorConfig = DetectorConfig(),
                 tag_id: Optional[int] = None, device=None):
        self.device = host_data_device(device)
        self.K_host = np.asarray(K, np.float32)
        self.K = torch.as_tensor(self.K_host, device=self.device)
        d = np.zeros(8, np.float32) if dist is None else \
            np.asarray(dist, np.float32).reshape(-1)
        self.dist = torch.as_tensor(
            np.concatenate([d, np.zeros(8)])[:8].astype(np.float32),
            device=self.device)
        self.tag_size = float(tag_size)
        self.cfg = config
        self.det_cfg = det_cfg
        self.roi_cfg = _roi_detector_config(det_cfg, config.roi)
        self.want_id = tag_id
        self.reset()

    def reset(self):
        self._rvec = None          # device (3,) prior
        self._tvec = None          # device (3,) prior
        self._t_host = None        # host copy of the prior t
        self._id = -1
        self._missed = 0

    # -- registration ------------------------------------------------
    def _register(self, img: torch.Tensor) -> TrackResult:
        if self.cfg.robust_register:
            from repas_tpu_torch.detect.robust import detect_tags_robust
            det = detect_tags_robust(img, self.det_cfg)
        else:
            det = self._detect(img[None], self.det_cfg)
            det = type(det)(*(x[0] for x in det))
        valid = det.valid & (det.decision_margin >= self.cfg.min_margin)
        if self.want_id is not None:
            valid = valid & (det.ids == self.want_id)
        i = torch.argmax(torch.where(valid, det.decision_margin,
                                     -1.0)).reshape(1)
        # decoded corners are already in canonical order: IPPE-square
        # directly (the 8-order search would tie across the square's
        # symmetries and could hand the LM a z-flipped prior)
        R, t, err = self._ippe(det.corners.index_select(0, i)[0], self.K,
                               self.tag_size, dist=self.dist)
        rvec = rodrigues_inv(R)
        host = torch.cat([valid.any().to(torch.float32)[None],
                          det.ids.index_select(0, i).to(torch.float32),
                          err[None], R.reshape(9), t]).cpu().numpy()
        err_f = float(host[2])
        if not host[0]:
            self.reset()
            return TrackResult(False, -1, np.eye(3), np.zeros(3),
                               float("inf"), "lost")
        if not np.isfinite(err_f) or err_f > self.cfg.max_err_px * 2:
            self.reset()
            return TrackResult(False, -1, np.eye(3), np.zeros(3), err_f,
                               "lost")
        self._id = int(host[1])
        self._rvec, self._tvec = rvec, t
        self._t_host = host[12:15].copy()
        self._missed = 0
        return TrackResult(True, self._id, host[3:12].reshape(3, 3),
                           host[12:15], err_f, "register")

    # -- prediction --------------------------------------------------
    def _predict_roi_origin(self, shape, roi: int) -> tuple:
        """Top-left of the ROI centered on the projected tag origin,
        clipped into the image (never negative)."""
        K, t = self.K_host, self._t_host
        z = max(float(t[2]), 1e-6)
        u = K[0, 0] * float(t[0]) / z + K[0, 2]
        v = K[1, 1] * float(t[1]) / z + K[1, 2]
        h, w = shape[:2]
        u0 = int(np.clip(round(u - roi / 2), 0, max(w - roi, 0)))
        v0 = int(np.clip(round(v - roi / 2), 0, max(h - roi, 0)))
        return u0, v0

    # -- public step -------------------------------------------------
    def step(self, rgb) -> TrackResult:
        img = torch.as_tensor(rgb).to(self.device, non_blocking=True)
        if self._rvec is None:
            return self._register(img)

        h, w = img.shape[:2]
        roi = min(self.cfg.roi, h, w)
        u0, v0 = self._predict_roi_origin(img.shape, roi)
        if not (0 <= u0 <= w - roi and 0 <= v0 <= h - roi):
            raise RuntimeError(f"ROI origin ({u0}, {v0}) outside the "
                               f"{h}x{w} frame")
        origin = torch.tensor([u0, v0, self._id], dtype=torch.int32).to(
            self.device, non_blocking=True)
        found, rvec, tvec, err, _ = self._track(
            img, origin[0], origin[1], origin[2], self._rvec, self._tvec,
            self.K, self.dist, self.tag_size, self.roi_cfg, roi,
            self.cfg.min_margin, self.cfg.gn_iters)
        host = torch.cat([found.to(torch.float32)[None], err[None], tvec,
                          rodrigues(rvec).reshape(9),
                          rodrigues(self._rvec).reshape(9)]).cpu().numpy()
        err_f = float(host[1])
        if host[0] and err_f <= self.cfg.max_err_px:
            self._rvec, self._tvec = rvec, tvec
            self._t_host = host[2:5].copy()
            self._missed = 0
            return TrackResult(True, self._id, host[5:14].reshape(3, 3),
                               host[2:5], err_f, "track")
        self._missed += 1
        if self._missed > self.cfg.max_misses:
            return self._register(img)
        # hold the prior while within the miss budget
        return TrackResult(False, self._id, host[14:23].reshape(3, 3),
                           self._t_host.copy(), err_f, "lost")
