"""Depth-corrected translation.

Port of ``repas_tpu/pose/depth_correct.py`` (``depth_corrected_translation``:
project the PnP translation into the image, take a median-window depth
there, and deproject it to P_depth, which replaces the PnP translation;
``z_scale_correction``: scale the translation to a measured depth).
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels.pointcloud import median_depth_window


def depth_corrected_translation(t: torch.Tensor, depth_m: torch.Tensor,
                                K: torch.Tensor, win: int = 5,
                                fallback_win: int = 11):
    """t (B,N,3) translations, depth_m (B,H,W) meters -> (P_depth (B,N,3),
    valid (B,N) bool).

    u,v = round(K t / t_z) (half to even); Zc = median window depth,
    retried with the fallback window where the small one has no valid
    depth; X=(u-cx)Zc/fx, Y=(v-cy)Zc/fy. Invalid (P = t) where t_z <= 0,
    the pixel is outside the image, or no depth exists."""
    K = K.to(torch.float32)
    t = t.to(torch.float32)
    h, w = depth_m.shape[-2:]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    tz_ok = t[..., 2] > 1e-6
    z = torch.where(tz_ok, t[..., 2], 1.0)
    u = torch.round(fx * t[..., 0] / z + cx).to(torch.int32)
    v = torch.round(fy * t[..., 1] / z + cy).to(torch.int32)
    in_img = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    Zc = median_depth_window(depth_m, u, v, win=win)
    Zc_fb = median_depth_window(depth_m, u, v, win=fallback_win)
    Zc = torch.where(Zc > 0, Zc, Zc_fb)
    valid = tz_ok & in_img & (Zc > 0)
    X = (u.to(torch.float32) - cx) / fx * Zc
    Y = (v.to(torch.float32) - cy) / fy * Zc
    P = torch.stack([X, Y, Zc], dim=-1)
    return torch.where(valid[..., None], P, t), valid


def z_scale_correction(t: torch.Tensor, z_pcd):
    """Scale translations t (...,3) so their z matches a measured depth
    z_pcd (...): s = z_pcd / t_z (1 where |t_z| <= 1e-9), returns
    (s t (...,3), s (...))."""
    s = torch.where(torch.abs(t[..., 2]) > 1e-9, z_pcd / t[..., 2], 1.0)
    return t * s[..., None], s
