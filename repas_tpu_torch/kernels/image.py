"""Image kernels of the detector's front end.

Port of ``repas_tpu/kernels/image.py`` (``pack_rgb_u32``,
``gray_from_u32``, ``rgb_to_gray``, ``decimate``, ``adaptive_threshold``,
``bilinear_sample_patch``, ``gaussian_blur``, ``gamma_lut``, ``clahe``).
Every function broadcasts over leading
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


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    """The reference's normalised f32 taps, computed once on the host so
    every device blurs with the same bits."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _conv1d_edge(x: torch.Tensor, taps: tuple, dim: int) -> torch.Tensor:
    """Edge-padded 1-D correlation along `dim` as shifted multiply-adds,
    summed tap by tap from the first: no cuDNN (TF32 on the card) and one
    fixed order on every device."""
    n = x.shape[dim]
    r = len(taps) // 2
    pos = torch.arange(n, device=x.device)
    out = None
    for j, k in enumerate(taps):
        idx = torch.clamp(pos + (j - r), 0, n - 1)
        term = torch.index_select(x, dim, idx) * k
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None
                  ) -> torch.Tensor:
    """Separable Gaussian blur over the last two dims (edge padding):
    along rows, then along columns, as the reference convolves."""
    if sigma <= 0:
        return img
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    taps = tuple(_gaussian_kernel1d(float(sigma), radius).tolist())
    x = _conv1d_edge(img.to(torch.float32), taps, img.ndim - 1)
    return _conv1d_edge(x, taps, img.ndim - 2)


def gamma_lut(img: torch.Tensor, gamma: float) -> torch.Tensor:
    """Gamma correction (the reference's LUT equivalent). The division is
    a multiply by the f32 reciprocal, as XLA folds it (probed)."""
    x = torch.clamp(img.to(torch.float32) * (1.0 / 255.0), 0.0, 1.0)
    return torch.pow(x, gamma) * 255.0


def _cumsum256(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumsum over a last dim of 256 in the order XLA's CPU
    backend sums ``jnp.cumsum`` there (probed bit-exact): sequential
    running sums inside 16-wide blocks, a sequential running sum of the
    block totals, and each block's exclusive prefix added last. The sums
    are not integers, so the order is part of the result; torch.cumsum
    accumulates in double on the CPU and in a tree on the card."""
    blk = x.reshape(*x.shape[:-1], 16, 16)
    inner = [blk[..., 0]]
    for i in range(1, 16):
        inner.append(inner[-1] + blk[..., i])
    inner = torch.stack(inner, dim=-1)                    # (...,16,16)
    pre = [torch.zeros_like(inner[..., 0, -1])]
    for b in range(15):
        pre.append(pre[-1] + inner[..., b, -1])
    pre = torch.stack(pre, dim=-1)                        # exclusive
    return (inner + pre[..., None]).reshape(x.shape)


def clahe(gray: torch.Tensor, clip_limit: float = 2.0, tiles: int = 8
          ) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation over (...,H,W).

    Tile histograms (256 bins) are clipped, redistributed, turned into
    CDFs and bilinearly interpolated between tile centres. The reference
    counts bins with one-hot compares and applies the LUTs as a one-hot
    einsum over quarter-tile blocks (its gather form where tiles are odd
    or the image is not a multiple of the tile grid). Here the counts are
    integer scatter-adds and the LUTs are read with one gather per corner
    for every pixel: each one-hot row holds a single 1, so the einsum
    returns exactly the LUT entry, and the gather's per-pixel tile index
    equals the block's. The 720p one-hot would be 0.94 GB per image.
    """
    g = torch.clamp(gray.to(torch.float32), 0.0, 255.0)
    lead = g.shape[:-2]
    h, w = g.shape[-2:]
    th, tw = h // tiles, w // tiles
    hc, wc = th * tiles, tw * tiles
    bins = 256
    gc = g[..., :hc, :wc].reshape(*lead, tiles, th, tiles, tw)
    gc = gc.transpose(-3, -2).reshape(*lead, tiles * tiles, th * tw)
    idx = torch.clamp(gc.to(torch.int64), 0, bins - 1)
    hist = torch.zeros(*lead, tiles * tiles, bins, dtype=torch.int32,
                       device=g.device)
    hist.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))
    hist = hist.to(torch.float32)
    clip = clip_limit * (th * tw) / bins
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=-1,
                       keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / bins
    cdf = _cumsum256(hist)
    cdf = (cdf - cdf[..., :1]) / torch.clamp(cdf[..., -1:] - cdf[..., :1],
                                             min=1e-6)
    luts = (cdf * 255.0).reshape(*lead, tiles * tiles * bins)

    dev = g.device
    # XLA folds the division by a constant into a multiply by its f32
    # reciprocal (probed)
    ty = torch.clamp((torch.arange(h, dtype=torch.float32, device=dev)
                      - th / 2) * (1.0 / th), 0.0, tiles - 1.001)
    tx = torch.clamp((torch.arange(w, dtype=torch.float32, device=dev)
                      - tw / 2) * (1.0 / tw), 0.0, tiles - 1.001)
    ty0 = torch.floor(ty)
    tx0 = torch.floor(tx)
    fy = (ty - ty0)[:, None]
    fx = (tx - tx0)[None, :]
    gi = torch.clamp(g.to(torch.int64), 0, bins - 1)
    base = ((ty0.to(torch.int64)[:, None] * tiles
             + tx0.to(torch.int64)[None, :]) * bins + gi).reshape(*lead, -1)

    def lut(dy, dx):
        return torch.gather(luts, -1, base + (dy * tiles + dx) * bins
                            ).reshape(g.shape)

    v00, v01, v10, v11 = lut(0, 0), lut(0, 1), lut(1, 0), lut(1, 1)
    # ((1-fy)*((1-fx)*v00 + fx*v01) + fy*((1-fx)*v10 + fx*v11)) with the
    # multiply-adds XLA's CPU backend contracts into FMAs (probed)
    top = _fma(1 - fx, v00, fx * v01)
    bot = _fma(1 - fx, v10, fx * v11)
    return _fma(1 - fy, top, fy * bot)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c rounded once, as a fused multiply-add (PyTorch has no
    fma op). The f64 product of two f32 values is exact; the f64 sum is
    rounded to odd (its error, by TwoSum, moves an even result one ulp
    toward the exact sum), so the final rounding to f32 is the only one
    that counts: a plain f64 sum would round twice."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.to(torch.float32)


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
