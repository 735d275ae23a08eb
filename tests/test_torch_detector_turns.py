"""The port's detector on tags turned in plane, against the corners that
were drawn (the JAX package misses large turned tags and every tag
turned near 22.5 + 45k degrees, so it is no reference here).

One tag36h11 tag (id 16) a frame, fronto-parallel, rendered with noise
sigma 2 at sides of 61, 120 and 220 px, turned 0-360 degrees in steps of
7.5 degrees and exactly 22.5 + 45k degrees (the turns at which a tag edge
lies normal to a sampled support direction). Every tag must decode to
its id, once, with its corners in the canonical order within a mean of
2.0 px of the drawn ones. And every support point of every candidate
component is a pixel of that component, or the pixel beside its
members at a one-pixel step of its outline (``_support_points``' tie
rule), at each of those turns.
"""
import functools

import numpy as np
import pytest
import torch

from repas_tpu_torch.core.config import DetectorConfig
from repas_tpu_torch.detect import detector as TD
from repas_tpu_torch.detect import render as TR
from repas_tpu_torch.kernels import ccl
from repas_tpu_torch.kernels.image import (adaptive_threshold, decimate,
                                           rgb_to_gray)
from torch_threads import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TAG_ID = 16
SIDES = (61, 120, 220)
TURNS = sorted(set([7.5 * k for k in range(48)]
                   + [22.5 + 45.0 * k for k in range(8)]))


def _rz(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1.0]])


@functools.lru_cache(maxsize=None)
def turned_frames(side):
    """(rgbs (N,H,W,3) uint8, drawn corners (N,4,2) TL,TR,BR,BL) of the
    tag at `side` px and each of TURNS, on a square frame that holds the
    tag at any turn."""
    h = w = int(side * 1.6) + 40 + (-(int(side * 1.6) + 40)) % 8
    f, z = 500.0, 0.5
    K = np.array([[f, 0, w / 2 - 0.3], [0, f, h / 2 + 0.2], [0, 0, 1.0]])
    size = side * z / f
    rng = np.random.default_rng(side)
    rgbs, corners = [], []
    for deg in TURNS:
        R, t = _rz(deg), np.array([0.0, 0.0, z])
        g = TR.render_tag_in_scene(TAG_ID, R, t, K, size, (h, w))
        g = np.clip(g + rng.normal(0, 2.0, g.shape), 0, 255)
        rgbs.append(np.repeat(g[..., None], 3, axis=-1).astype(np.uint8))
        hs = size / 2
        c = (np.array([[-hs, -hs, 1], [hs, -hs, 1], [hs, hs, 1],
                       [-hs, hs, 1]])
             @ (K @ np.column_stack([R[:, 0], R[:, 1], t])).T)
        corners.append(c[:, :2] / c[:, 2:])
    return np.stack(rgbs), np.stack(corners)


@pytest.mark.parametrize("side", SIDES)
def test_every_turn_decodes_with_its_drawn_corners(side):
    rgbs, drawn = turned_frames(side)
    det = TD.detect_tags(torch.from_numpy(rgbs), DetectorConfig())
    ids, valid = det.ids.numpy(), det.valid.numpy()
    corners = det.corners.numpy()
    missed, far = [], []
    for i, deg in enumerate(TURNS):
        hit = valid[i] & (ids[i] == TAG_ID)
        if hit.sum() != 1 or (valid[i] & ~hit).any():
            missed.append((deg, ids[i][valid[i]].tolist()))
            continue
        d = np.linalg.norm(corners[i][hit][0] - drawn[i], axis=-1).mean()
        if d > 2.0:
            far.append((deg, float(d)))
    assert not missed and not far, (missed, far)


@pytest.mark.parametrize("side", SIDES)
def test_support_points_are_member_pixels(side):
    """A support point off the component has a member pixel among its
    eight neighbours; the reference's points lie up to tens of pixels
    out here."""
    rgbs, _ = turned_frames(side)
    cfg = DetectorConfig()
    gray = decimate(rgb_to_gray(torch.from_numpy(rgbs)), 2)
    binary, ambiguous = adaptive_threshold(gray, tile=cfg.tile,
                                           min_contrast=cfg.min_contrast)
    labels = ccl.connected_components((~binary) & (~ambiguous),
                                      cfg.ccl_iters, converge=True)
    hl, wl = gray.shape[-2:]
    roots, _, valid, bbox = ccl.top_k_components(
        labels, cfg.max_components, min_area=cfg.min_area_px / 4,
        max_area=cfg.max_area_frac * hl * wl, ring_filter=True,
        min_side=4.0, return_bbox=True)
    sup = TD._support_points(labels, roots, bbox)        # (B,C,16,2)
    xs, ys = sup[..., 0].long(), sup[..., 1].long()
    assert torch.equal(sup, torch.stack([xs, ys], -1).to(sup.dtype))
    b = torch.arange(len(TURNS))[:, None, None]
    member = labels[b, ys.clamp(0, hl - 1), xs.clamp(0, wl - 1)] == \
        roots[..., None]
    beside = torch.zeros_like(member)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            beside |= labels[b, (ys + dy).clamp(0, hl - 1),
                             (xs + dx).clamp(0, wl - 1)] == roots[..., None]
    assert valid.any(dim=1).all()
    assert beside[valid].all(), [
        (TURNS[i], int((~beside[i][valid[i]]).sum()))
        for i in range(len(TURNS)) if not beside[i][valid[i]].all()]
