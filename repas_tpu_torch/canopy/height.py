"""Plant-height measurement.

Port of ``repas_tpu/canopy/height.py`` (``CanopyResult``,
``measure_plant_height``), the path's entry point:
  1. bar detection at 1/proc_decimate resolution (Canny, Hough) and the
     rotation that levels it -- the image itself is never warped;
  2. the bar midpoint's median depth (5, then 11 px) and its 3-D point;
  3-4. colour-model foreground and the strict green mask (decimated);
  4b. the plant mask grown back into the full-resolution strict-green
     mask (thin leaf tips lost to decimation and opening);
  5. the canopy mark: the highest plant pixel in the bar-aligned frame,
     x the median of that top band;
  6. the mark mapped back to full-resolution image coordinates;
  7. its depth (plant-masked 25 px median, then the plain medians) and
     3-D point;
  8. height = |bar_Y - canopy_Y|.
Runs where its inputs lie and reads nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repas_tpu_torch.canopy.bar import detect_bar
from repas_tpu_torch.canopy.segment import (_reconstruct_by_dilation,
                                            apply_green_mask,
                                            green_seed_mask,
                                            refine_plant_mask)
from repas_tpu_torch.core.config import CanopyConfig
from repas_tpu_torch.kernels.image import (decimate, hsv_in_range,
                                           invert_affine, rgb_to_hsv_cv,
                                           transform_points_2d)
from repas_tpu_torch.kernels.pointcloud import (masked_median_depth_window,
                                                median_depth_window)
from repas_tpu_torch.kernels.project import deproject_pixels


class CanopyResult(NamedTuple):
    found: torch.Tensor           # () bool
    plant_height_m: torch.Tensor  # ()
    canopy_3d: torch.Tensor       # (3,)
    bar_3d: torch.Tensor          # (3,)
    canopy_px: torch.Tensor       # (2,) original-image pixel
    canopy_px_rot: torch.Tensor   # (2,) bar-aligned-frame coords
    bar_px: torch.Tensor          # (2,)
    rotation_deg: torch.Tensor    # ()
    plant_mask: torch.Tensor      # (H,W) bool (unrotated, decimated)


def _median(depth_m, u, v, win, mask=None):
    """One window median of an (H,W) depth at integer pixel (u, v)."""
    args = (depth_m[None], u.reshape(1, 1), v.reshape(1, 1))
    if mask is None:
        return median_depth_window(*args, win)[0, 0]
    return masked_median_depth_window(depth_m[None], mask[None],
                                      *args[1:], win)[0, 0]


def measure_plant_height(rgb: torch.Tensor, depth_m: torch.Tensor, K,
                         cfg: CanopyConfig = CanopyConfig()) -> CanopyResult:
    """rgb (H,W,3) uint8, depth_m (H,W) aligned depth in metres, K (3,3).

    The 2-D stages run at 1/cfg.proc_decimate resolution; the depth
    lookups, the tip recovery and the deprojection use the full image."""
    dev = rgb.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    dec = max(1, int(cfg.proc_decimate))
    if dec > 1:
        rgb_proc = torch.stack([decimate(rgb[..., c], dec) for c in range(3)],
                               dim=-1)
    else:
        rgb_proc = rgb

    def to_full(px):
        return px * dec + (dec - 1) / 2.0

    # 1. bar line + rotation matrix, no image warp
    line, M = detect_bar(
        rgb_proc, cfg.canny_low, cfg.canny_high,
        max(1, cfg.hough_threshold // dec),
        cfg.min_coverage, cfg.max_bar_angle_deg)

    # 2. bar 3D at the segment midpoint in full-resolution coords
    bar_px = to_full((line.p0 + line.p1) / 2.0)
    bu = torch.round(bar_px[0]).to(torch.int32)
    bv = torch.round(bar_px[1]).to(torch.int32)
    bz = _median(depth_m, bu, bv, cfg.depth_win)
    bz = torch.where(bz > 0, bz,
                     _median(depth_m, bu, bv, cfg.depth_fallback_win))
    bar_3d = deproject_pixels(bar_px, bz, K)

    # 3-4. segmentation on the (unrotated) decimated image
    seed = green_seed_mask(rgb_proc, cfg.green_seed_lo, cfg.green_seed_hi)
    fg = refine_plant_mask(rgb_proc, seed, iters=cfg.grabcut_iters)
    plant = apply_green_mask(rgb_proc, fg, cfg.green_lo, cfg.green_hi,
                             cfg.morph_kernel)

    # 4b. full-resolution tip recovery: grow the upsampled plant mask into
    # the full-resolution strict-green mask
    if dec > 1:
        hf, wf = rgb.shape[0], rgb.shape[1]
        strict_full = hsv_in_range(rgb_to_hsv_cv(rgb), cfg.green_lo,
                                   cfg.green_hi)
        marker = plant.repeat_interleave(dec, 0).repeat_interleave(dec, 1)
        marker = torch.nn.functional.pad(
            marker, (0, wf - marker.shape[1], 0, hf - marker.shape[0]))
        plant_scan = _reconstruct_by_dilation(marker, strict_full,
                                              cfg.tip_reconstruct_iters)

        # full-res pixel -> proc coords (low-res pixel i covers full-res
        # [i*dec, i*dec+dec-1])
        def to_proc(v):
            return (v - (dec - 1) / 2.0) / dec
    else:
        plant_scan = plant

        def to_proc(v):
            return v

    # 5. canopy mark by projection into the bar-aligned frame
    hs, ws = plant_scan.shape
    yg, xg = torch.meshgrid(
        to_proc(torch.arange(hs, dtype=torch.float32, device=dev)),
        to_proc(torch.arange(ws, dtype=torch.float32, device=dev)),
        indexing="ij")
    yr = M[1, 0] * xg + M[1, 1] * yg + M[1, 2]
    xr = M[0, 0] * xg + M[0, 1] * yg + M[0, 2]
    yr_m = torch.where(plant_scan, yr, torch.inf)
    y_top = torch.amin(yr_m)
    c_found = torch.isfinite(y_top)
    # the top 'row': rotated-frame rows within one full-res pixel of the
    # minimum; x is the median of that band
    band = plant_scan & (yr_m < y_top + 1.0 / dec)
    xr_band = torch.sort(torch.where(band, xr, torch.inf).reshape(-1)).values
    cnt = torch.sum(band)
    x_top = xr_band.index_select(0, torch.clamp((cnt - 1) // 2, min=0)
                                 .reshape(1))[0]
    canopy_rot = torch.stack([x_top, y_top])

    # 6. inverse-rotate, then map to full-resolution original coords
    canopy_px = to_full(transform_points_2d(invert_affine(M), canopy_rot))

    # 7. canopy depth + 3D: plant-mask pixels of a wider window first (a
    # thin tip lets the camera read the background), then the plain medians
    cu = torch.round(canopy_px[0]).to(torch.int32)
    cv = torch.round(canopy_px[1]).to(torch.int32)
    cz = _median(depth_m, cu, cv, cfg.canopy_depth_win, mask=plant_scan)
    cz = torch.where(cz > 0, cz, _median(depth_m, cu, cv, cfg.depth_win))
    cz = torch.where(cz > 0, cz,
                     _median(depth_m, cu, cv, cfg.depth_fallback_win))
    canopy_3d = deproject_pixels(canopy_px, cz, K)

    # 8. height
    height = torch.abs(bar_3d[1] - canopy_3d[1])
    found = line.found & c_found & (bz > 0) & (cz > 0)
    return CanopyResult(
        found=found, plant_height_m=height, canopy_3d=canopy_3d,
        bar_3d=bar_3d, canopy_px=canopy_px, canopy_px_rot=canopy_rot,
        bar_px=bar_px, rotation_deg=line.angle_deg, plant_mask=plant)
