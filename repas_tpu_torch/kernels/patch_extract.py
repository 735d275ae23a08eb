"""Per-candidate ROI windows out of a row-concatenated image pyramid.

Port of ``repas_tpu/kernels/patch_extract.py`` (``aligned_ok``,
``_aligned_starts``, ``extract_patches_pyramid``). Carries kernel B2:
``extract_windows`` launches ``csrc/patch_extract.cu`` on CUDA tensors and
runs its plain version on CPU tensors.

The window geometry is the reference's: window starts are rounded down
to (16, 128) tiles and the windows are (ph+16, pw+192), so the samplers
absorb the residual through the returned origin. Where that geometry
does not fit (small images) the windows degrade to the exact (ph, pw)
ones at the given origins; both geometries go through the same kernel.

The same kernel also carries the two window copies of the measurement
tool ``tools/micro_perf.py``: B5 (``extract_windows_blk``, its
``_extract_dma_batched``: windows at starts in tile units, f32 or bf16)
and B6 (``extract_windows_exact``, the ``extract_dma`` closure of its
``dmapatch2`` section: exact windows at arbitrary starts).
"""
from __future__ import annotations

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


def _aligned_starts(y0, x0, hp, w, ph, pw):
    ah, aw = ph + COVER_H, pw + COVER_W
    ay = torch.clamp((y0 // ROW_TILE) * ROW_TILE, max=hp - ah)
    ax = torch.clamp((x0 // LANE_TILE) * LANE_TILE, max=w - aw)
    return ay, ax


def extract_windows_plain(pyr: torch.Tensor, origins: torch.Tensor,
                          ah: int, aw: int) -> torch.Tensor:
    """Plain PyTorch B2: pyr (B,Hp,W), origins (B,C,2) [y, x] ->
    (B,C,ah,aw); origins clamped so each window fits (dynamic_slice)."""
    B, hp, w = pyr.shape
    y = torch.clamp(origins[..., 0].long(), 0, hp - ah)
    x = torch.clamp(origins[..., 1].long(), 0, w - aw)
    rows = y[..., None] + torch.arange(ah, device=pyr.device)
    cols = x[..., None] + torch.arange(aw, device=pyr.device)
    bidx = torch.arange(B, device=pyr.device)[:, None, None, None]
    return pyr[bidx, rows[..., :, None], cols[..., None, :]]


def extract_windows(pyr: torch.Tensor, origins: torch.Tensor,
                    ah: int, aw: int) -> torch.Tensor:
    """B2 dispatch: the CUDA kernel for CUDA tensors (bf16 pyramid), the
    plain version for CPU tensors."""
    if not pyr.is_cuda:
        return extract_windows_plain(pyr, origins, ah, aw)
    if pyr.dtype != torch.bfloat16:
        raise ValueError(f"extract_windows: needs a bf16 pyramid, got "
                         f"{pyr.dtype}")
    _check_cuda_windows("extract_windows", pyr, origins, ah, aw)
    return _launch("patch_extract", pyr, origins, ah, aw, 0, 1, 1)


def _launch(key: str, pyr: torch.Tensor, starts: torch.Tensor, ah: int,
            aw: int, yi: int, y_unit: int, x_unit: int) -> torch.Tensor:
    """One launch of csrc/patch_extract.cu, counted under `key`: window
    (b, c) at y = starts[b, c, yi] * y_unit, x = starts[b, c, 1 - yi] *
    x_unit, clamped to fit. The caller has checked the inputs."""
    B, hp, w = pyr.shape
    C = starts.shape[1]
    out = torch.empty((B, C, ah, aw), dtype=pyr.dtype, device=pyr.device)
    _build.launch("repas_patch_extract", pyr.device, pyr.data_ptr(),
                  starts.data_ptr(), out.data_ptr(), B, C, hp, w, ah, aw,
                  pyr.element_size(), yi, y_unit, x_unit)
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
                         "for the vector copy")


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
    through ``blk_origins``. The kernel clamps every window into the
    pyramid, so an unchecked start past the edge reads no memory out of
    bounds; it is copied from the last origin that fits."""
    if not pyr.is_cuda:
        return extract_windows_blk_plain(pyr, starts_blk, ph, pw, tile_h)
    _check_cuda_windows("extract_windows_blk", pyr, starts_blk, ph, pw)
    if not checked:
        blk_origins(pyr.shape, starts_blk, ph, pw, tile_h)
    return _launch("patch_blk", pyr, starts_blk, ph, pw, 1, tile_h,
                   LANE_TILE)


def extract_windows_exact_plain(pyr: torch.Tensor, starts: torch.Tensor,
                                ph: int, pw: int) -> torch.Tensor:
    """Plain PyTorch B6: pyr (B,Hp,W), starts (B,C,2) int32 [x, y] ->
    (B,C,ph,pw) exact windows, each start clamped so the window fits
    (the reference clamps the cover's tile block, ``_mkinfo``, and its
    yardstick ``dynamic_slice`` the start)."""
    return extract_windows_plain(pyr, torch.flip(starts, dims=(-1,)), ph, pw)


def extract_windows_exact(pyr: torch.Tensor, starts: torch.Tensor, ph: int,
                          pw: int) -> torch.Tensor:
    """B6 dispatch: the CUDA kernel (one launch) for CUDA tensors (2- or
    4-byte elements), the plain version for CPU tensors."""
    if not pyr.is_cuda:
        return extract_windows_exact_plain(pyr, starts, ph, pw)
    _check_cuda_windows("extract_windows_exact", pyr, starts, ph, pw)
    return _launch("patch_exact", pyr, starts, ph, pw, 1, 1, 1)


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
    else:
        ah, aw = ph, pw
        ay, ax = y0, x0
    origins = torch.stack([ay, ax], dim=-1).to(torch.int32).contiguous()
    return extract_windows(pyr, origins, ah, aw), ay, ax
