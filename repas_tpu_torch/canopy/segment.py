"""Plant segmentation.

Port of ``repas_tpu/canopy/segment.py`` (``green_seed_mask``,
``_hsv_bins``, ``refine_plant_mask``, ``_reconstruct_by_dilation``,
``apply_green_mask``, ``canopy_level_mark``). The reference replaces
GrabCut with an iterated colour-model refinement: a green HSV seed, then
foreground/background histograms over quantised HSV, a likelihood-ratio
reassignment and open/close smoothing per iteration; then the strict
green range with open/close and a geodesic reconstruction of thin tips.

``refine_plant_mask`` counts the histograms with ``bincount`` and reads
the log-ratio table with one gather, where the reference builds
(pixels x 18) and (pixels x 64) one-hot matrices and einsums them (its
TPU form; 44 MB at the 360x640 working resolution). Each one-hot row
holds a single 1, so the reference's sums have one term: counts and
table entries are the same numbers (ROADMAP C). It is a compiled step
(``core.jit``: one CUDA graph per image shape and ``iters`` on the card,
the loop over ``iters`` captured unrolled).
"""
from __future__ import annotations

import functools

import torch

from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.kernels.image import (dilate, hsv_in_range,
                                           morph_close, morph_open,
                                           rgb_to_hsv_cv)

_H_BINS, _S_BINS, _V_BINS = 18, 8, 8


def green_seed_mask(rgb: torch.Tensor,
                    lo=(35, 40, 40), hi=(85, 255, 255)) -> torch.Tensor:
    return hsv_in_range(rgb_to_hsv_cv(rgb), lo, hi)


def _hsv_bins(hsv: torch.Tensor) -> torch.Tensor:
    """Quantised HSV bin (18 x 8 x 8) per pixel. The reference's
    ``h / 180 * 18`` is a multiply by an f32 reciprocal under XLA; every
    form (two steps, reciprocal, one folded constant) gives the same bins
    on all 256^3 RGB colours (probed), so the reference's is kept."""
    hb = torch.clamp((hsv[..., 0] / 180.0 * _H_BINS).to(torch.int32), 0,
                     _H_BINS - 1)
    sb = torch.clamp((hsv[..., 1] / 256.0 * _S_BINS).to(torch.int32), 0,
                     _S_BINS - 1)
    vb = torch.clamp((hsv[..., 2] / 256.0 * _V_BINS).to(torch.int32), 0,
                     _V_BINS - 1)
    return (hb * _S_BINS + sb) * _V_BINS + vb


@functools.partial(jit, static_argnames=("iters",))
def refine_plant_mask(rgb: torch.Tensor, seed: torch.Tensor,
                      iters: int = 5) -> torch.Tensor:
    """GrabCut-lite: iterative histogram likelihood refinement of the
    seeded foreground of an (H,W,3) image."""
    bins = _hsv_bins(rgb_to_hsv_cv(rgb)).reshape(-1).to(torch.int64)
    n_bins = _H_BINS * _S_BINS * _V_BINS
    # per-bin pixel counts (index_add_, not bincount: no host read)
    total = torch.zeros(n_bins, dtype=torch.int64, device=bins.device
                        ).index_add_(0, bins, torch.ones_like(bins))
    mask = seed
    for _ in range(iters):
        m = mask.reshape(-1)
        # +1 Laplace smoothing on every bin, as the reference's tables
        fg = torch.zeros(n_bins, dtype=torch.int64, device=bins.device
                         ).index_add_(0, bins, m.to(torch.int64))
        fg2 = (fg + 1).to(torch.float32)
        bg2 = (total - fg + 1).to(torch.float32)
        fg2 = fg2 / torch.sum(fg2)
        bg2 = bg2 / torch.sum(bg2)
        T = torch.log(fg2) - torch.log(bg2)
        llr = T[bins]
        new = (llr > 0.0).reshape(mask.shape)
        # keep the seed as probable-FG prior; smooth boundaries
        new = new & (morph_close(mask) > 0) | seed
        mask = morph_open(new) > 0
    return mask


def _reconstruct_by_dilation(marker: torch.Tensor, limit: torch.Tensor,
                             iters: int = 8, step: int = 7) -> torch.Tensor:
    """Geodesic reconstruction: grow `marker` inside `limit` by `iters`
    step x step dilations. Recovers thin structures (leaf tips) that the
    opening erased without re-admitting isolated specks."""
    m = marker & limit
    for _ in range(iters):
        m = (dilate(m, step) > 0) & limit
    return m


def apply_green_mask(rgb: torch.Tensor, plant_mask: torch.Tensor,
                     lo=(35, 80, 30), hi=(85, 255, 255),
                     kernel: int = 3, reconstruct_iters: int = 8
                     ) -> torch.Tensor:
    """Strict green range + MORPH_OPEN + MORPH_CLOSE on the foreground,
    then geodesic reconstruction of the opened mask into the strict-green
    region (keeps thin tips connected to the plant body)."""
    strict = hsv_in_range(rgb_to_hsv_cv(rgb), lo, hi)
    green = strict & plant_mask
    g = morph_open(green, kernel)
    g = morph_close(g, kernel) > 0
    if reconstruct_iters > 0:
        g = _reconstruct_by_dilation(g, strict, reconstruct_iters, step=3)
    return g


def canopy_level_mark(mask: torch.Tensor):
    """Highest plant pixel of an (H,W) mask: the first row with any mask,
    x = the median (lower middle) of that row's mask pixels. Returns
    (canopy_y, canopy_x, found); y and x are -1 when nothing is found."""
    h, w = mask.shape
    rows = torch.any(mask, dim=1)
    found = torch.any(rows)
    y = torch.argmax(rows.to(torch.int32))           # first True row
    row = mask[y]
    xs = torch.arange(w, device=mask.device)
    cnt = torch.sum(row)
    sorted_x = torch.sort(torch.where(row, xs, w + 1)).values
    x = sorted_x[torch.clamp((cnt - 1) // 2, min=0)]
    return (torch.where(found, y, -1).to(torch.int32),
            torch.where(found, x, -1).to(torch.int32), found)
