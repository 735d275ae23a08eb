"""Kernel B1: connected-component labels on the GPU.

Replaces the Pallas kernel ``repas_tpu/kernels/ccl_pallas.py::_ccl_kernel``
(entry ``connected_components_pallas``) with ``csrc/ccl.cu``: per round a
row-scan, a column-scan and a stencil launch (3 * iters launches), the
label image ping-ponging between the output and one scratch buffer in
device memory (L2-resident at the main path's batch). The result is the
fixed-iteration labelling of ``ccl.connected_components_plain``, bit for
bit. See the source's header for what bounds it on the H100.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels import _build


def connected_components_cuda(mask: torch.Tensor, iters: int = 5
                              ) -> torch.Tensor:
    """(B,H,W) bool mask on a CUDA device -> (B,H,W) int32 labels."""
    if not mask.is_cuda:
        raise ValueError("connected_components_cuda: mask must be a CUDA "
                         "tensor")
    if mask.dtype != torch.bool or mask.ndim != 3:
        raise ValueError("connected_components_cuda: needs a (B,H,W) bool "
                         f"mask, got {tuple(mask.shape)} {mask.dtype}")
    if iters < 1:
        raise ValueError(f"connected_components_cuda: iters={iters} < 1")
    B, h, w = mask.shape
    if h * w >= 2 ** 31 - 1:
        raise ValueError("connected_components_cuda: H*W must fit int32")
    mask = mask.contiguous()
    out = torch.empty((B, h, w), dtype=torch.int32, device=mask.device)
    scratch = torch.empty_like(out)
    _build.launch("repas_ccl", mask.device, mask.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), B, h, w, iters)
    _build.launches["ccl"] += 1
    return out
