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
    B, hp, w = pyr.shape
    if (pyr.dtype != torch.bfloat16 or origins.dtype != torch.int32
            or origins.device != pyr.device
            or origins.shape[0] != B or origins.ndim != 3
            or origins.shape[2] != 2):
        raise ValueError(
            "extract_windows: needs pyr (B,Hp,W) bf16 and origins (B,C,2) "
            f"int32 on one device; got {tuple(pyr.shape)} {pyr.dtype}, "
            f"{tuple(origins.shape)} {origins.dtype} on {origins.device}")
    if not (0 < ah <= hp and 0 < aw <= w):
        raise ValueError(f"extract_windows: window {ah}x{aw} does not fit "
                         f"a {hp}x{w} pyramid")
    if not (pyr.is_contiguous() and origins.is_contiguous()):
        raise ValueError("extract_windows: inputs must be contiguous")
    if pyr.data_ptr() % 16:
        raise ValueError("extract_windows: pyramid storage must be 16-byte "
                         "aligned for the vector copy")
    C = origins.shape[1]
    out = torch.empty((B, C, ah, aw), dtype=pyr.dtype, device=pyr.device)
    _build.launch("repas_patch_extract", pyr.device, pyr.data_ptr(),
                  origins.data_ptr(), out.data_ptr(), B, C, hp, w, ah, aw)
    _build.launches["patch_extract"] += 1
    return out


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
