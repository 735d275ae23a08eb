"""Image kernels of the detector's front end.

Port of ``repas_tpu/kernels/image.py`` (``pack_rgb_u32``,
``gray_from_u32``, ``rgb_to_gray``, ``decimate``, ``adaptive_threshold``,
``bilinear_sample_patch``). Every function broadcasts over leading
(batch) dimensions. Packed RGB is int32, not uint32: CPU torch has no
``>>`` on uint32, and the 24-bit values fit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_rgb_u32(img: torch.Tensor) -> torch.Tensor:
    """(...,H,W,3) uint8 -> (...,H,W) int32 with r | g<<8 | b<<16."""
    x = img.to(torch.int32)
    return x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16)


def gray_from_u32(packed: torch.Tensor) -> torch.Tensor:
    """(...,H,W) int32 r|g<<8|b<<16 -> BT.601 luma float32 [0,255]."""
    r = (packed & 255).to(torch.float32)
    g = ((packed >> 8) & 255).to(torch.float32)
    b = ((packed >> 16) & 255).to(torch.float32)
    return 0.299 * r + 0.587 * g + 0.114 * b


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(...,H,W,3) RGB -> BT.601 luma float32 (cv2 RGB2GRAY weights)."""
    if img.dtype == torch.uint8:
        return gray_from_u32(pack_rgb_u32(img))
    img = img.to(torch.float32)
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def decimate(img: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool decimation over (...,H,W) (quad_decimate equivalent).

    The window sum runs in row-major order, ((a+b)+c)+d for 2x2, the
    order of the reference's ``reduce_window`` add on the CPU at the
    pipeline's shapes, then scales by 1/f^2. The gray values are not
    integers, so the order is part of the result.
    """
    if factor <= 1:
        return img
    h, w = img.shape[-2:]
    h2, w2 = h // factor, w // factor
    x = img[..., : h2 * factor, : w2 * factor].to(torch.float32)
    s = None
    for dy in range(factor):
        for dx in range(factor):
            part = x[..., dy::factor, dx::factor]
            s = part if s is None else s + part
    return s * (1.0 / (factor * factor))


def _window3(t: torch.Tensor, fill: float, reduce) -> torch.Tensor:
    """3x3 'SAME' window reduction over the last two dims, border = fill."""
    h, w = t.shape[-2:]
    p = F.pad(t, (1, 1, 1, 1), value=fill)
    out = t
    for dy in range(3):
        for dx in range(3):
            out = reduce(out, p[..., dy:dy + h, dx:dx + w])
    return out


def adaptive_threshold(gray: torch.Tensor, tile: int = 4,
                       min_contrast: float = 10.0):
    """AprilTag-style tile adaptive threshold over (...,H,W).

    Per-(tile x tile) min/max, then min/max over the 3x3 tile
    neighbourhood, threshold at (min+max)/2; pixels whose neighbourhood
    contrast is below min_contrast are ambiguous.
    Returns (binary (...,H,W) bool [True = white], ambiguous bool).
    """
    g = gray.to(torch.float32)
    h, w = g.shape[-2:]
    th, tw = h // tile, w // tile
    lead = g.shape[:-2]
    g_crop = g[..., : th * tile, : tw * tile].reshape(*lead, th, tile, tw,
                                                     tile)
    tmin = torch.amin(g_crop, dim=(-3, -1))
    tmax = torch.amax(g_crop, dim=(-3, -1))
    nmin = _window3(tmin, float("inf"), torch.minimum)
    nmax = _window3(tmax, float("-inf"), torch.maximum)
    thresh_t = 0.5 * (nmin + nmax)
    contrast_t = nmax - nmin

    def upsample(t):
        t = t.repeat_interleave(tile, dim=-2).repeat_interleave(tile, dim=-1)
        pad_h, pad_w = h - th * tile, w - tw * tile
        if pad_h or pad_w:
            t = F.pad(t.reshape(-1, 1, th * tile, tw * tile),
                      (0, pad_w, 0, pad_h), mode="replicate")
            t = t.reshape(*lead, h, w)
        return t

    binary = g > upsample(thresh_t)
    ambiguous = upsample(contrast_t) < min_contrast
    return binary, ambiguous


def bilinear_sample_patch(patch: torch.Tensor, uv: torch.Tensor
                          ) -> torch.Tensor:
    """Gather-free bilinear sampling of small patches at float coords.

    patch (N,h,w), uv (N,...,2) -> (N,...). Hat-weight contraction as in
    the reference: W_row[p,y] = max(0, 1-|y - v_p|) rounded to bf16, the
    patch rounded to bf16, the product accumulated in f32, then the
    column hats applied in f32. Each output sums at most two nonzero
    products per contraction, and bf16 x bf16 products are exact in f32,
    so any f32 accumulation order gives the same bits.
    """
    patch = patch.to(torch.bfloat16).to(torch.float32)
    n, h, w = patch.shape
    u = torch.clamp(uv[..., 0], 0.0, w - 1.001).reshape(n, -1, 1)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.001).reshape(n, -1, 1)
    hi = torch.arange(h, dtype=torch.float32, device=patch.device)
    wi = torch.arange(w, dtype=torch.float32, device=patch.device)
    wr = torch.clamp(1.0 - torch.abs(hi - v), min=0.0)          # (N,P,h)
    wc = torch.clamp(1.0 - torch.abs(wi - u), min=0.0)          # (N,P,w)
    t = torch.bmm(wr.to(torch.bfloat16).to(torch.float32), patch)
    return torch.sum(t * wc, dim=-1).reshape(uv.shape[:-1])
