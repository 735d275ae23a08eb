"""Per-candidate ROI windows out of a row-concatenated image pyramid.

Port of ``repas_tpu/kernels/patch_extract.py`` (``aligned_ok``,
``_aligned_starts``, ``extract_patches_pyramid``). Carries kernel B2:
``extract_windows`` launches ``csrc/patch_extract.cu`` on CUDA tensors and
runs its plain version on CPU tensors.

The window geometry is the reference's: window starts are rounded down
to (16, 128) tiles and the windows are (ph+16, pw+192), so the samplers
absorb the residual through the returned origin. Where that geometry
does not fit (small images) the windows degrade to the exact (ph, pw)
ones at the given origins.

The same source also carries the two window copies of the measurement
tool ``tools/micro_perf.py``: B5 (``extract_windows_blk``, its
``_extract_dma_batched``: windows at starts in tile units, f32 or bf16)
and B6 (``extract_windows_exact``, the ``extract_dma`` closure of its
``dmapatch2`` section: exact windows at arbitrary starts).

Every start follows ``jax.lax.dynamic_slice``'s rule (``slice_start``): a
negative start has the dimension added, then it is clamped so the window
fits. ``window_copy_path`` picks each launch's kernel from the geometry
alone: the 16-byte vector copy where every x origin is on a vector by
construction (B2's aligned scheme, B5), the TMA copy for windows at
arbitrary x (B6, B2's degraded geometry) where TMA takes the geometry,
and the element-by-element copy where it does not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repas_tpu_torch.kernels import _build

ROW_TILE = 16      # tile rows of the aligned-window scheme
LANE_TILE = 128    # tile columns
COVER_H = 16       # aligned window margins: AH = ph + COVER_H
COVER_W = 192      # AW = pw + COVER_W


def aligned_ok(pyr_shape, ph: int, pw: int) -> bool:
    """True when the aligned-window scheme applies to this geometry."""
    hp, w = pyr_shape[-2:]
    ah, aw = ph + COVER_H, pw + COVER_W
    return (w >= aw and (w - aw) % LANE_TILE == 0 and hp >= ah
            and ph % ROW_TILE == 0)


# TMA copy plan (csrc/patch_extract.cu, window_copy_tma)
TMA_MAX_BOX = 256          # TMA's largest box side, in elements
TMA_BOX_BYTES = 16384      # largest box (one row band) a stage holds
TMA_MIN_BH = 8             # smallest row band
TMA_STAGES = 4             # shared buffers in each CTA's ring
TMA_CTAS_PER_SM = 4        # persistent CTAs on each SM, where they fit
SM_SMEM_BYTES = 233472     # an H100 SM's shared memory (228 KB)
CTA_SMEM_RESERVED = 1024   # of it reserved for each CTA


def slice_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``jax.lax.dynamic_slice``'s rule for start indices along a dimension
    of `dim` elements and a slice of `size`: a negative start has `dim`
    added, then every start is clamped to [0, dim - size]. int64."""
    s = start.long()
    s = torch.where(s < 0, s + dim, s)
    return torch.clamp(s, 0, max(dim - size, 0))


def window_copy_path(pyr_shape, elem_size: int, ah: int, aw: int,
                     x_align: int = 1) -> str:
    """The kernel a window copy launches, from its geometry alone (no read
    of the starts): "vector" (16-byte vector copy) when every x origin is
    a multiple of `x_align` by construction and that, the window width and
    the row pitch all fall on 16-byte vectors; else "tma" when TMA takes
    the geometry (2- or 4-byte elements, the row pitch a multiple of 16
    bytes, the window width of 4); else "scalar" (element by element)."""
    w = pyr_shape[-1]
    vec = 16 // elem_size
    if x_align % vec == 0 and w % vec == 0 and aw % vec == 0:
        return "vector"
    if elem_size in (2, 4) and (w * elem_size) % 16 == 0 \
            and (aw * elem_size) % 4 == 0:
        return "tma"
    return "scalar"


class TmaPlan(NamedTuple):
    bh: int             # rows of a band (the box's height)
    bw: int             # window columns a box covers (the box loads bw +
                        # one 16-byte vector, from x rounded down to one)
    cols: int           # column boxes per band
    bands: int          # bands per window
    tasks: int          # boxes in all
    stages: int         # ring buffers per CTA
    grid: int           # persistent CTAs
    smem_bytes: int     # dynamic shared memory per CTA


def tma_plan(B: int, C: int, ah: int, aw: int, elem_size: int,
             sm_count: int, bh: int | None = None,
             stages: int = TMA_STAGES,
             ctas_per_sm: int = TMA_CTAS_PER_SM) -> TmaPlan:
    """The TMA copy's launch plan for B x C windows of ah x aw: column boxes
    covering bw window columns each, of equal width on 16-byte vectors,
    each box bw plus one vector wide and at most 256 elements; row bands
    of the largest power of two whose box fits TMA_BOX_BYTES (at most ah
    rows), halved down to TMA_MIN_BH while the boxes number fewer than the
    CTAs the card holds (a batch-1 call still fills the SMs); one
    persistent CTA per box up to `ctas_per_sm` per SM, fewer where their
    rings do not fit an SM's shared memory. `bh` overrides the band
    height."""
    vec = 16 // elem_size
    cols = -(-aw // (TMA_MAX_BOX - vec))
    per_box = -(-aw // cols)
    bw = -(-per_box // vec) * vec
    box_w = bw + vec
    target = sm_count * ctas_per_sm
    if bh is None:
        bh = TMA_MAX_BOX
        while bh > TMA_MIN_BH and bh * box_w * elem_size > TMA_BOX_BYTES:
            bh //= 2
        bh = min(bh, ah)
        while bh > TMA_MIN_BH and B * C * -(-ah // bh) * cols < target:
            bh //= 2
    bh = min(bh, ah)
    bands = -(-ah // bh)
    tasks = B * C * bands * cols
    stage = -(-bh * box_w * elem_size // 128) * 128
    smem = 128 + stages * (stage + 8)
    per_sm = max(1, min(ctas_per_sm,
                        SM_SMEM_BYTES // (smem + CTA_SMEM_RESERVED)))
    return TmaPlan(bh, bw, cols, bands, tasks, stages,
                   max(1, min(tasks, sm_count * per_sm)), smem)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(pyr: torch.Tensor, C: int, ah: int, aw: int,
                x_align: int = 1):
    """(path, TmaPlan or None) of a launch on `pyr` (B,Hp,W) of C windows
    a frame of ah x aw: what the wrappers launch, and what chip_smoke.py
    reports beside the kernel's time."""
    path = window_copy_path(pyr.shape, pyr.element_size(), ah, aw, x_align)
    if path != "tma":
        return path, None
    return path, tma_plan(pyr.shape[0], C, ah, aw, pyr.element_size(),
                          _sm_count(pyr.device))


def _aligned_starts(y0, x0, hp, w, ph, pw):
    ah, aw = ph + COVER_H, pw + COVER_W
    ay = torch.clamp((y0 // ROW_TILE) * ROW_TILE, max=hp - ah)
    ax = torch.clamp((x0 // LANE_TILE) * LANE_TILE, max=w - aw)
    return ay, ax


def extract_windows_plain(pyr: torch.Tensor, origins: torch.Tensor,
                          ah: int, aw: int) -> torch.Tensor:
    """Plain PyTorch B2: pyr (B,Hp,W), origins (B,C,2) [y, x] ->
    (B,C,ah,aw); origins taken by dynamic_slice's rule (``slice_start``)."""
    B, hp, w = pyr.shape
    y = slice_start(origins[..., 0], hp, ah)
    x = slice_start(origins[..., 1], w, aw)
    rows = y[..., None] + torch.arange(ah, device=pyr.device)
    cols = x[..., None] + torch.arange(aw, device=pyr.device)
    bidx = torch.arange(B, device=pyr.device)[:, None, None, None]
    return pyr[bidx, rows[..., :, None], cols[..., None, :]]


def extract_windows(pyr: torch.Tensor, origins: torch.Tensor,
                    ah: int, aw: int, *, x_align: int = 1) -> torch.Tensor:
    """B2 dispatch: the CUDA kernel for CUDA tensors (bf16 pyramid), the
    plain version for CPU tensors. `x_align` is the caller's promise that
    every x origin is a multiple of it (B2's aligned scheme: LANE_TILE);
    it selects the kernel (``window_copy_path``)."""
    if not pyr.is_cuda:
        return extract_windows_plain(pyr, origins, ah, aw)
    if pyr.dtype != torch.bfloat16:
        raise ValueError(f"extract_windows: needs a bf16 pyramid, got "
                         f"{pyr.dtype}")
    _check_cuda_windows("extract_windows", pyr, origins, ah, aw)
    return _launch("patch_extract", pyr, origins, ah, aw, 0, 1, 1, x_align)


def run_copy(pyr: torch.Tensor, starts: torch.Tensor, ah: int, aw: int,
             yi: int, y_unit: int, x_unit: int,
             plan: TmaPlan | None) -> torch.Tensor:
    """Launch csrc/patch_extract.cu on checked CUDA inputs: window (b, c)
    at y = starts[b, c, yi] * y_unit, x = starts[b, c, 1 - yi] * x_unit,
    each by dynamic_slice's rule; the TMA copy under `plan`, or the
    vector / element copy when `plan` is None. A refused tensor map or
    launch raises."""
    B, hp, w = pyr.shape
    C = starts.shape[1]
    tma = (1, plan.bh, plan.bw, plan.stages, plan.grid) if plan else \
        (0, 0, 0, 0, 0)
    out = torch.empty((B, C, ah, aw), dtype=pyr.dtype, device=pyr.device)
    _build.launch("repas_patch_extract", pyr.device, pyr.data_ptr(),
                  starts.data_ptr(), out.data_ptr(), B, C, hp, w, ah, aw,
                  pyr.element_size(), yi, y_unit, x_unit, *tma)
    return out


def _launch(key: str, pyr: torch.Tensor, starts: torch.Tensor, ah: int,
            aw: int, yi: int, y_unit: int, x_unit: int,
            x_align: int) -> torch.Tensor:
    """One launch through the kernel ``launch_plan`` names, counted under
    `key`. The caller has checked the inputs."""
    plan = launch_plan(pyr, starts.shape[1], ah, aw, x_align)[1]
    out = run_copy(pyr, starts, ah, aw, yi, y_unit, x_unit, plan)
    _build.launches[key] += 1
    return out


def _check_cuda_windows(name: str, pyr: torch.Tensor, starts: torch.Tensor,
                        ah: int, aw: int) -> None:
    """B5's and B6's input checks: a (B,Hp,W) pyramid of 2- or 4-byte
    elements and (B,C,2) int32 starts on its card, both contiguous, the
    pyramid 16-byte aligned, the window no larger than the pyramid."""
    B, hp, w = pyr.shape
    if (pyr.element_size() not in (2, 4) or starts.dtype != torch.int32
            or starts.device != pyr.device or starts.ndim != 3
            or starts.shape[0] != B or starts.shape[2] != 2):
        raise ValueError(
            f"{name}: needs pyr (B,Hp,W) of 2- or 4-byte elements and "
            f"starts (B,C,2) int32 on one device; got {tuple(pyr.shape)} "
            f"{pyr.dtype}, {tuple(starts.shape)} {starts.dtype} on "
            f"{starts.device}")
    if not (0 < ah <= hp and 0 < aw <= w):
        raise ValueError(f"{name}: window {ah}x{aw} does not fit a {hp}x{w} "
                         "pyramid")
    if not (pyr.is_contiguous() and starts.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if pyr.data_ptr() % 16:
        raise ValueError(f"{name}: pyramid storage must be 16-byte aligned "
                         "for the vector and TMA copies")


def blk_origins(pyr_shape, starts_blk: torch.Tensor, ph: int, pw: int,
                tile_h: int) -> torch.Tensor:
    """B5's window origins (B,C,2) [y, x] in elements, on the host, from
    starts in (tile_h, 128) tile units [x_block, y_block]; raises
    ValueError when a window does not fit the pyramid (the TPU kernel's
    DMA refuses such a start too). Reads the starts on the host."""
    hp, w = pyr_shape[-2:]
    s = starts_blk.detach().to("cpu", torch.int64)
    y = s[..., 1] * tile_h
    x = s[..., 0] * LANE_TILE
    bad = (x < 0) | (y < 0) | (x + pw > w) | (y + ph > hp)
    if bool(bad.any()):
        b, c = (int(i) for i in bad.nonzero()[0])
        raise ValueError(
            f"extract_windows_blk: window {ph}x{pw} at block start "
            f"{s[b, c].tolist()} (element [y, x] = [{int(y[b, c])}, "
            f"{int(x[b, c])}]) of slot ({b}, {c}) does not fit a {hp}x{w} "
            "pyramid")
    return torch.stack([y, x], dim=-1)


def extract_windows_blk_plain(pyr: torch.Tensor, starts_blk: torch.Tensor,
                              ph: int, pw: int, tile_h: int) -> torch.Tensor:
    """Plain PyTorch B5: pyr (B,Hp,W) any dtype, starts_blk (B,C,2) int32
    [x_block, y_block] in (tile_h, 128) tile units -> (B,C,ph,pw), window
    (b, c) = pyr[b, y_block*tile_h : +ph, x_block*128 : +pw]. Raises
    ValueError when a window does not fit."""
    origins = blk_origins(pyr.shape, starts_blk, ph, pw, tile_h)
    return extract_windows_plain(pyr, origins.to(pyr.device), ph, pw)


def extract_windows_blk(pyr: torch.Tensor, starts_blk: torch.Tensor,
                        ph: int, pw: int, tile_h: int, *,
                        checked: bool = False) -> torch.Tensor:
    """B5 dispatch: the CUDA kernel for CUDA tensors (2- or 4-byte
    elements), the plain version for CPU tensors. Either raises
    ValueError, before any launch, when a window does not fit; on the
    card that check reads the starts on the host (one synchronisation),
    unless `checked` says the caller has already passed these starts
    through ``blk_origins``. The kernel takes each element start by
    dynamic_slice's rule, so an unchecked start outside the pyramid reads
    no memory out of bounds."""
    if not pyr.is_cuda:
        return extract_windows_blk_plain(pyr, starts_blk, ph, pw, tile_h)
    _check_cuda_windows("extract_windows_blk", pyr, starts_blk, ph, pw)
    if not checked:
        blk_origins(pyr.shape, starts_blk, ph, pw, tile_h)
    return _launch("patch_blk", pyr, starts_blk, ph, pw, 1, tile_h,
                   LANE_TILE, LANE_TILE)


def extract_windows_exact_plain(pyr: torch.Tensor, starts: torch.Tensor,
                                ph: int, pw: int) -> torch.Tensor:
    """Plain PyTorch B6: pyr (B,Hp,W), starts (B,C,2) int32 [x, y] ->
    (B,C,ph,pw) exact windows, each start by dynamic_slice's rule, as the
    reference's yardstick ``dynamic_slice`` takes it."""
    return extract_windows_plain(pyr, torch.flip(starts, dims=(-1,)), ph, pw)


def extract_windows_exact(pyr: torch.Tensor, starts: torch.Tensor, ph: int,
                          pw: int) -> torch.Tensor:
    """B6 dispatch: the CUDA kernel (one launch; the TMA copy where TMA
    takes the geometry) for CUDA tensors (2- or 4-byte elements), the
    plain version for CPU tensors."""
    if not pyr.is_cuda:
        return extract_windows_exact_plain(pyr, starts, ph, pw)
    _check_cuda_windows("extract_windows_exact", pyr, starts, ph, pw)
    return _launch("patch_exact", pyr, starts, ph, pw, 1, 1, 1, 1)


def extract_patches_pyramid(pyr: torch.Tensor, y0: torch.Tensor,
                            x0: torch.Tensor, ph: int, pw: int):
    """pyr (B,Hp,W), y0/x0 (B,C) int32 top-left corners of the EXACT
    (ph,pw) windows -> (patches (B,C,AH,AW), ay (B,C), ax (B,C)).

    ay, ax are each window's origin in pyramid coordinates; consumers
    sample at (coordinate - origin). When the geometry does not admit the
    aligned scheme, AH,AW degrade to (ph,pw) with ay,ax = y0,x0."""
    hp, w = pyr.shape[-2:]
    if aligned_ok(pyr.shape, ph, pw):
        ah, aw = ph + COVER_H, pw + COVER_W
        ay, ax = _aligned_starts(y0, x0, hp, w, ph, pw)
        x_align = LANE_TILE
    else:
        ah, aw = ph, pw
        ay, ax = y0, x0
        x_align = 1
    origins = torch.stack([ay, ax], dim=-1).to(torch.int32).contiguous()
    return extract_windows(pyr, origins, ah, aw, x_align=x_align), ay, ax
