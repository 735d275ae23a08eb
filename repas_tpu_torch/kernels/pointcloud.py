"""Depth -> point-cloud kernels and the depth median window.

Port of ``repas_tpu/kernels/pointcloud.py`` (``depth_to_meters``,
``depth_image_to_points``, ``fused_pointcloud``, ``rgbd_to_pointcloud``,
``xyzrgb_rows``, ``median_depth_window``,
``masked_median_depth_window``). Carries kernel B3:
``fused_pointcloud`` launches ``csrc/pointcloud.cu`` on CUDA tensors and
runs its plain version on CPU tensors. Both compute the reference Pallas
kernel's formula on every shape; the reference's XLA fallback (which the
JAX CPU tests see) divides instead of multiplying by 1/f, so the two
agree to a few ulp, not bit for bit.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels import _build
from repas_tpu_torch.kernels.image import pack_rgb_u32


def depth_to_meters(depth_u16: torch.Tensor, scale: float = 0.001
                    ) -> torch.Tensor:
    """u16 depth -> float32 meters."""
    return depth_u16.to(torch.float32) * scale


def depth_image_to_points(depth_m: torch.Tensor, K: torch.Tensor
                          ) -> torch.Tensor:
    """Dense deprojection: (...,H,W) meters -> (...,H,W,3) camera-frame
    XYZ, x = (u-cx)/fx*z, y = (v-cy)/fy*z."""
    h, w = depth_m.shape[-2:]
    dev = depth_m.device
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    z = depth_m
    return torch.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], dim=-1)


def fused_pointcloud_plain(depth_u16: torch.Tensor, rgb32: torch.Tensor,
                           K: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch B3: depth (B,H,W) uint16, packed rgb (B,H,W) int32
    -> planar (B,6,H*W) [x,y,z,r,g,b], in the Pallas kernel's order."""
    B, h, w = depth_u16.shape
    dev = depth_u16.device
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = depth_u16.to(torch.float32) * scale
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    inv255 = torch.where(z > 0, 1.0 / 255.0, 0.0)
    x = (u - cx) * z * (1.0 / fx)
    y = (v - cy) * z * (1.0 / fy)
    r = (rgb32 & 0xFF).to(torch.float32) * inv255
    g = ((rgb32 >> 8) & 0xFF).to(torch.float32) * inv255
    b = ((rgb32 >> 16) & 0xFF).to(torch.float32) * inv255
    return torch.stack([x, y, z, r, g, b], dim=1).reshape(B, 6, h * w)


def fused_pointcloud(depth_u16: torch.Tensor, rgb: torch.Tensor,
                     K: torch.Tensor, scale: float = 0.001) -> torch.Tensor:
    """Fused u16 depth + RGB -> planar (B,6,H*W) [x,y,z,r,g,b] rows.

    depth_u16 (B,H,W) uint16; rgb (B,H,W,3) uint8 or packed (B,H,W)
    int32 (kernels.image.pack_rgb_u32); K (3,3) on the same device.
    Planar (structure-of-arrays) output: use ``xyzrgb_rows`` for the
    (N,6) export layout."""
    if rgb.dtype == torch.uint8:
        rgb = pack_rgb_u32(rgb)
    K = K.to(torch.float32)
    if not depth_u16.is_cuda:
        return fused_pointcloud_plain(depth_u16, rgb, K, scale)
    B, h, w = depth_u16.shape
    if (depth_u16.dtype != torch.uint16 or rgb.dtype != torch.int32
            or tuple(rgb.shape) != (B, h, w) or tuple(K.shape) != (3, 3)
            or rgb.device != depth_u16.device
            or K.device != depth_u16.device):
        raise ValueError(
            "fused_pointcloud: needs depth (B,H,W) uint16, packed rgb "
            "(B,H,W) int32 and K (3,3) on one device; got "
            f"{tuple(depth_u16.shape)} {depth_u16.dtype}, "
            f"{tuple(rgb.shape)} {rgb.dtype}, {tuple(K.shape)} on "
            f"{rgb.device}/{K.device}")
    depth_u16 = depth_u16.contiguous()
    rgb = rgb.contiguous()
    K = K.contiguous()
    out = torch.empty((B, 6, h * w), dtype=torch.float32,
                      device=depth_u16.device)
    _build.launch("repas_pointcloud", depth_u16.device, depth_u16.data_ptr(),
                  rgb.data_ptr(), K.data_ptr(), float(scale), out.data_ptr(),
                  B, h, w)
    _build.launches["pointcloud"] += 1
    return out


def rgbd_to_pointcloud(rgb: torch.Tensor, depth_m: torch.Tensor,
                       K: torch.Tensor, mask: torch.Tensor | None = None,
                       min_depth: float = 1e-6,
                       max_depth: float = float("inf")):
    """RGB (...,H,W,3) uint8 + aligned depth (...,H,W) meters (+ optional
    (...,H,W) mask, kept where > 0) -> flat colored cloud (points
    (...,H*W,3), colors (...,H*W,3) in [0,1], valid (...,H*W) bool);
    invalid slots hold zeros. The reference's XLA deprojection:
    x = (u-cx)/fx*z."""
    pts = depth_image_to_points(depth_m, K)
    valid = (depth_m > min_depth) & (depth_m < max_depth) & \
        torch.isfinite(depth_m)
    if mask is not None:
        valid = valid & (mask > 0)
    pts = torch.where(valid[..., None], pts, 0.0)
    cols = torch.where(valid[..., None], rgb.to(torch.float32) / 255.0, 0.0)
    lead = depth_m.shape[:-2]
    return (pts.reshape(*lead, -1, 3), cols.reshape(*lead, -1, 3),
            valid.reshape(*lead, -1))


def xyzrgb_rows(pc_planar: torch.Tensor) -> torch.Tensor:
    """(...,6,N) planar cloud -> (...,N,6) xyzrgb rows (export layout)."""
    return pc_planar.transpose(-1, -2)


def median_depth_window(depth_m: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor, win: int = 5) -> torch.Tensor:
    """Median of valid depths in a win x win window around (u,v).

    depth_m (B,H,W); u, v (B,N) integer pixel coords -> (B,N). Median over
    finite positive values only, 0.0 where none; the window is clamped to
    the image by edge replication, as in the reference."""
    B, h, w = depth_m.shape
    r = max(1, win // 2)
    k = 2 * r + 1
    u = torch.clamp(u.to(torch.int64), 0, w - 1)
    v = torch.clamp(v.to(torch.int64), 0, h - 1)
    du = torch.arange(-r, r + 1, device=depth_m.device)
    uu = torch.clamp(u[..., None, None] + du[None, :], 0, w - 1)
    vv = torch.clamp(v[..., None, None] + du[:, None], 0, h - 1)
    idx = (vv * w + uu).reshape(B, -1)
    n_q = u.shape[-1]
    patch = torch.gather(depth_m.reshape(B, -1), 1, idx).reshape(B, n_q, k * k)
    valid = torch.isfinite(patch) & (patch > 0)
    n = valid.sum(dim=-1)
    big = torch.finfo(torch.float32).max
    vals = torch.sort(torch.where(valid, patch, big), dim=-1).values
    lo = torch.gather(vals, -1, torch.clamp((n - 1) // 2, min=0)[..., None])
    hi = torch.gather(vals, -1, torch.clamp(n // 2, min=0)[..., None])
    med = 0.5 * (lo[..., 0] + hi[..., 0])
    return torch.where(n > 0, med, 0.0)


def masked_median_depth_window(depth_m: torch.Tensor, mask: torch.Tensor,
                               u: torch.Tensor, v: torch.Tensor,
                               win: int = 25) -> torch.Tensor:
    """Median of valid depths over mask-true pixels in a win x win window
    around (u,v); 0.0 where none.

    depth_m and mask (B,H,W); u, v (B,N) integer pixel coords -> (B,N).
    A thin structure (a 1-2 px leaf tip) lets the plain window median
    read the background through it; restricting the median to mask
    pixels in a wider window anchors it to the plant body. An even count
    averages the two middle values, as the reference's median does."""
    B, h, w = depth_m.shape
    r = max(1, win // 2)
    k = 2 * r + 1
    u = torch.clamp(u.to(torch.int64), 0, w - 1)
    v = torch.clamp(v.to(torch.int64), 0, h - 1)
    du = torch.arange(-r, r + 1, device=depth_m.device)
    uu = torch.clamp(u[..., None, None] + du[None, :], 0, w - 1)
    vv = torch.clamp(v[..., None, None] + du[:, None], 0, h - 1)
    idx = (vv * w + uu).reshape(B, -1)
    n_q = u.shape[-1]
    patch = torch.gather(depth_m.reshape(B, -1), 1, idx).reshape(B, n_q, k * k)
    mpatch = torch.gather(mask.reshape(B, -1), 1, idx).reshape(B, n_q, k * k)
    valid = torch.isfinite(patch) & (patch > 0) & mpatch
    n = valid.sum(dim=-1)
    big = torch.finfo(torch.float32).max
    vals = torch.sort(torch.where(valid, patch, big), dim=-1).values
    lo = torch.gather(vals, -1, torch.clamp((n - 1) // 2, min=0)[..., None])
    hi = torch.gather(vals, -1, torch.clamp(n // 2, min=0)[..., None])
    med = 0.5 * (lo[..., 0] + hi[..., 0])
    return torch.where(n > 0, med, 0.0)
