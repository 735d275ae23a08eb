"""Image kernels of the detector's front end.

Port of ``repas_tpu/kernels/image.py`` (``pack_rgb_u32``,
``gray_from_u32``, ``rgb_to_gray``, ``decimate``, ``adaptive_threshold``,
``bilinear_sample_patch``, ``extract_patches``, ``gaussian_blur``,
``gamma_lut``, ``clahe``,
``sobel``, the morphology, ``bilinear_sample``, the 2-D affine helpers,
``warp_affine``, ``rgb_to_hsv_cv``, ``hsv_in_range``).
The detector's functions broadcast over leading (batch) dimensions;
``bilinear_sample``, the affine helpers and ``warp_affine`` take one
image, as the canopy and calibration paths call them. Packed RGB is
int32, not uint32: CPU torch has no ``>>`` on uint32, and the 24-bit
values fit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repas_tpu_torch.kernels.patch_extract import slice_start


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
    g_crop = g[..., : th * tile, : tw * tile]
    tmin = _pool2d(g_crop, tile, "min")
    tmax = _pool2d(g_crop, tile, "max")
    nmin = _window2d(tmin, 3, "min")
    nmax = _window2d(tmax, 3, "max")
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
    """Edge-padded 1-D correlation along `dim` as shifted multiply-adds in
    one fixed order on every device (no cuDNN, which runs TF32 on the
    card). Up to 8 taps the products are summed in XLA's CPU order
    (probed bit-exact at 3, 5 and 7 taps): adjacent pairs, the pairs in
    sequence, then the odd last tap. Longer kernels sum tap by tap from
    the first, which is not XLA's order (ROADMAP C)."""
    n = x.shape[dim]
    r = len(taps) // 2
    pos = torch.arange(n, device=x.device)
    terms = [torch.index_select(x, dim, torch.clamp(pos + (j - r), 0, n - 1))
             * k for j, k in enumerate(taps)]
    if len(terms) > 8:
        out = terms[0]
        for term in terms[1:]:
            out = out + term
        return out
    out = None
    for j in range(0, len(terms), 2):
        pair = terms[j] + terms[j + 1] if j + 1 < len(terms) else terms[j]
        out = pair if out is None else out + pair
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


def extract_patches(img: torch.Tensor, starts_xy: torch.Tensor,
                    size: tuple) -> torch.Tensor:
    """(C,2) integer top-left corners (x, y) -> (C,ph,pw) patches of the
    (H,W) image, one gather. Starts should be pre-clamped to keep slices
    in bounds; each is taken by ``jax.lax.dynamic_slice``'s rule
    (``patch_extract.slice_start``): a negative start counts from the
    end, and a start past the last fitting position is clamped to it."""
    ph, pw = size
    h, w = img.shape
    ar_y = torch.arange(ph, device=img.device)
    ar_x = torch.arange(pw, device=img.device)
    sx = slice_start(starts_xy[:, 0], w, pw)
    sy = slice_start(starts_xy[:, 1], h, ph)
    return img[(sy[:, None] + ar_y)[:, :, None],
               (sx[:, None] + ar_x)[:, None, :]]


def _pad_edge(img: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicating pad of the last two dims by r (jnp.pad 'edge')."""
    h, w = img.shape[-2:]
    dev = img.device
    rows = torch.clamp(torch.arange(-r, h + r, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-r, w + r, device=dev), 0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def sobel(img: torch.Tensor):
    """Sobel gradients (gx, gy) over the last two dims, cv2.Sobel ksize=3
    convention (edge padding), summed in the reference's order."""
    img = img.to(torch.float32)
    p = _pad_edge(img, 1)
    tl, tc, tr = p[..., :-2, :-2], p[..., :-2, 1:-1], p[..., :-2, 2:]
    ml, mr = p[..., 1:-1, :-2], p[..., 1:-1, 2:]
    bl, bc, br = p[..., 2:, :-2], p[..., 2:, 1:-1], p[..., 2:, 2:]
    gx = (tr + 2 * mr + br) - (tl + 2 * ml + bl)
    gy = (bl + 2 * bc + br) - (tl + 2 * tc + tr)
    return gx, gy


def _pool_max(x: torch.Tensor, size: int, stride: int, pad: int):
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), size, stride=stride,
                     padding=pad)
    return y.reshape(*lead, *y.shape[-2:])


def _pool2d(img: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """Non-overlapping size x size max or min pooling ('VALID')."""
    x = img.to(torch.float32)
    if op == "max":
        return _pool_max(x, size, size, 0)
    return -_pool_max(-x, size, size, 0)


def _window2d(img: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """size x size 'SAME' max or min window over the last two dims, the
    border padded with -inf (max) or +inf (min) as the reference's
    ``reduce_window`` init. Min is a negated max-pool, which pads with
    -inf: exact. The reference's windows are odd-sized."""
    if size % 2 == 0:
        raise ValueError(f"window size must be odd, got {size}")
    x = img.to(torch.float32)
    if op == "max":
        return _pool_max(x, size, 1, size // 2)
    return -_pool_max(-x, size, 1, size // 2)


def dilate(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Grayscale/binary dilation with a size x size box (cv2.dilate)."""
    return _window2d(img, size, "max")


def erode(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    return _window2d(img, size, "min")


def morph_open(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """cv2.MORPH_OPEN: erode then dilate."""
    return dilate(erode(img, size), size)


def morph_close(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """cv2.MORPH_CLOSE: dilate then erode."""
    return erode(dilate(img, size), size)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample a 2-D image (H,W) at float pixel coords uv (...,2),
    clamped to [0, size - 1.001], blended as ``_blend``."""
    img = img.to(torch.float32)
    h, w = img.shape
    u = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    base = v0.to(torch.int64) * w + u0.to(torch.int64)
    flat = img.reshape(-1)
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + w]
    i11 = flat[base + w + 1]
    return _blend(fu, fv, i00, i01, i10, i11)


def _blend(fu, fv, i00, i01, i10, i11):
    """((1-fv)*((1-fu)*i00 + fu*i01) + fv*((1-fu)*i10 + fu*i11)) with the
    multiply-adds XLA's CPU backend contracts into FMAs (probed)."""
    top = _fma(fu, i01, (1 - fu) * i00)
    bot = _fma(fu, i11, (1 - fu) * i10)
    return _fma(1 - fv, top, fv * bot)


def get_rotation_matrix_2d(center, angle_deg, scale: float = 1.0
                           ) -> torch.Tensor:
    """cv2.getRotationMatrix2D: 2x3 affine rotating about center.

    Positive angle rotates counter-clockwise in image coords. `angle_deg`
    is a tensor (its device is used) or a number (on the CPU). The
    f32 angle's cos and sin are taken in float64 and rounded: the same
    bits on every device, and XLA's f32 cos (sin) in 99.9 % (97.7 %) of
    angles, where torch's f32 ones match in 93 % (98.8 %) (probed)."""
    a = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32))
    ca = torch.cos(a.to(torch.float64)).to(torch.float32) * scale
    sa = torch.sin(a.to(torch.float64)).to(torch.float32) * scale
    cx, cy = float(center[0]), float(center[1])
    return torch.stack([
        torch.stack([ca, sa, (1 - ca) * cx - sa * cy]),
        torch.stack([-sa, ca, sa * cx + (1 - ca) * cy]),
    ])


def _inv2(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (...,2,2) matrices with the rounding of the reference's
    ``jnp.linalg.inv`` on the CPU (LU with partial pivoting, then the
    triangular solves; probed bit-exact on rotation matrices): the
    pivot's and U's diagonal are applied as multiplies by their f32
    reciprocals, and the back substitution's last step is an FMA.
    ``torch.linalg.inv`` differs from it by an ulp in a third of them."""
    swap = torch.abs(A[..., 1, 0]) > torch.abs(A[..., 0, 0])
    r0 = torch.where(swap[..., None], A[..., 1, :], A[..., 0, :])
    r1 = torch.where(swap[..., None], A[..., 0, :], A[..., 1, :])
    a00, a01, a10, a11 = r0[..., 0], r0[..., 1], r1[..., 0], r1[..., 1]
    l = a10 * (1.0 / a00)
    u11 = a11 - l * a01
    one, zero = torch.ones_like(a00), torch.zeros_like(a00)
    cols = []
    for e0, e1 in ((one, zero), (zero, one)):
        y0 = torch.where(swap, e1, e0)
        y1 = torch.where(swap, e0, e1) - l * y0
        x1 = y1 * (1.0 / u11)
        x0 = _fma(-a01, x1, y0) * (1.0 / a00)
        cols.append(torch.stack([x0, x1], dim=-1))
    return torch.stack(cols, dim=-1)


def invert_affine(M: torch.Tensor) -> torch.Tensor:
    """cv2.invertAffineTransform for a (...,2,3) matrix."""
    Ainv = _inv2(M[..., :, :2])
    b = M[..., :, 2]
    # (-Ainv) @ b as XLA's CPU dot sums it: fma(n1, b1, n0 * b0) (probed)
    n = -Ainv
    t = _fma(n[..., 1], b[..., 1:2].expand_as(n[..., 1]),
             n[..., 0] * b[..., 0:1])
    return torch.cat([Ainv, t[..., None]], dim=-1)


def transform_points_2d(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 2x3 affine to (...,2) points (cv2.transform). The matrix
    product is summed as XLA's CPU dot sums it, fma(y, M[:,1], x*M[:,0])
    (probed, one point or many), then the offset added."""
    x, y = pts[..., :1], pts[..., 1:]
    return _fma(y.expand(*pts.shape), M[:, 1].expand(*pts.shape),
                x * M[:, 0]) + M[:, 2]


def warp_affine(img: torch.Tensor, M: torch.Tensor,
                out_shape: tuple[int, int] | None = None,
                border_value: float = 0.0) -> torch.Tensor:
    """cv2.warpAffine with bilinear sampling and a constant border, on
    (H,W) or (H,W,C) images; M maps src -> dst."""
    h, w = img.shape[:2]
    oh, ow = out_shape if out_shape is not None else (h, w)
    Minv = invert_affine(M)
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    src = transform_points_2d(Minv, torch.stack([xx, yy], dim=-1))
    inb = ((src[..., 0] >= 0) & (src[..., 0] <= w - 1)
           & (src[..., 1] >= 0) & (src[..., 1] <= h - 1))
    if img.ndim == 2:
        return torch.where(inb, bilinear_sample(img, src), border_value)
    outs = [torch.where(inb, bilinear_sample(img[..., c], src), border_value)
            for c in range(img.shape[2])]
    return torch.stack(outs, dim=-1)


def rgb_to_hsv_cv(img: torch.Tensor) -> torch.Tensor:
    """RGB uint8 (...,3) -> OpenCV-convention HSV (H in [0,180), S, V in
    [0,255]), as cv2.cvtColor(..., COLOR_BGR2HSV) on RGB channel order."""
    x = img.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v > 0, 255.0 * diff / torch.clamp(v, min=1e-9), 0.0)
    safe = torch.clamp(diff, min=1e-9)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0
    return torch.stack([h, s, v], dim=-1)


def hsv_in_range(hsv: torch.Tensor, lo, hi) -> torch.Tensor:
    """cv2.inRange on an HSV image -> bool mask. cv2 stores HSV as uint8,
    so the values are rounded (half to even, as jnp.round) first. The
    bounds are numbers (no host-to-device copy)."""
    q = torch.round(hsv)
    out = None
    for c in range(3):
        m = (q[..., c] >= float(lo[c])) & (q[..., c] <= float(hi[c]))
        out = m if out is None else out & m
    return out
