"""Kernel B4: segmented min-scans along one axis, and the tiled CCL.

Replaces the Pallas kernels of
``repas_tpu/kernels/ccl_pallas.py::_make_scan_kernel`` (the row-band and
column-band calls of ``connected_components_pallas_tiled``). The unit
(``seg_scan_axis_*``, ``csrc/ccl_tiled.cu``) takes a mask and any int32
labels and returns the forward then backward segmented min-scan along
rows or columns, background reset to the sentinel H*W: the direct
counterpart of ``_make_scan_kernel``. The tiled CCL runs ``iters`` rounds
of row unit, column unit and the 8-neighbour stencil, as
``connected_components_pallas_tiled`` does (or, with ``converge``, on to
the fixed point, deciding on the card); on the card it is B1's
band-resident kernel (``csrc/ccl.cu``) in grid mode, always: cooperative
launches over groups of images, each band's labels in shared memory for
all rounds, one launch per group. Its labels equal B1's bit for bit.
``connected_components`` (ccl.py) sends masks over ``MAX_VMEM_PIXELS``
here. See the sources' headers for what bounds the kernels on the H100.

A CPU tensor goes through the plain versions below; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels import _build, ccl_cuda
from repas_tpu_torch.kernels.ccl import (_neighbor_min, _seg_min_scan,
                                         initial_labels, run_rounds)

# rows per chunk of the column unit's three-pass scan
COL_CHUNK = 16


def _axis_dim(dim: int) -> int:
    dim = dim % 3
    if dim not in (1, 2):
        raise ValueError(f"seg_scan_axis: dim {dim} is the batch; scan along "
                         "1 (columns) or 2 (rows) of (B,H,W)")
    return dim


def seg_scan_axis_plain(mask: torch.Tensor, labels: torch.Tensor,
                        dim: int) -> torch.Tensor:
    """Plain B4 unit on (B,H,W): forward then backward segmented min-scan
    along `dim` (2 = rows, 1 = columns), background reset to H*W after
    each direction, as ``_make_scan_kernel`` computes it."""
    dim = _axis_dim(dim)
    sentinel = mask.shape[1] * mask.shape[2]
    brk = ~mask
    lab = labels
    for reverse in (False, True):
        lab = torch.where(mask, _seg_min_scan(lab, brk, dim, reverse,
                                              sentinel), sentinel)
    return lab


def connected_components_tiled_plain(mask: torch.Tensor, iters: int = 5,
                                     converge: bool = False) -> torch.Tensor:
    """Plain tiled CCL of (B,H,W) masks: per round the row unit, the
    column unit, then the 8-neighbour stencil; with `converge`, on to
    the rounds' fixed point (``ccl.run_rounds``)."""
    sentinel = mask.shape[1] * mask.shape[2]

    def one_round(labels):
        labels = seg_scan_axis_plain(mask, labels, 2)
        labels = seg_scan_axis_plain(mask, labels, 1)
        return torch.where(mask, _neighbor_min(labels, sentinel), sentinel)

    return run_rounds(one_round, initial_labels(mask), iters, converge)


def _check_mask(name: str, mask: torch.Tensor) -> None:
    ccl_cuda.check_mask(name, mask, 1)
    if -(-mask.shape[1] // COL_CHUNK) > 65535:
        raise ValueError(f"{name}: shape {tuple(mask.shape)} out of range "
                         f"(H/{COL_CHUNK} at most 65535)")


def _aggregates(mask: torch.Tensor):
    B, h, w = mask.shape
    n = B * -(-h // COL_CHUNK) * w
    return (torch.empty(n, dtype=torch.int32, device=mask.device),
            torch.empty(n, dtype=torch.uint8, device=mask.device))


def seg_scan_axis_cuda(mask: torch.Tensor, labels: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """B4's unit on the card: (B,H,W) bool mask and int32 labels on one
    CUDA device -> (B,H,W) int32."""
    _check_mask("seg_scan_axis_cuda", mask)
    if (labels.dtype != torch.int32 or labels.shape != mask.shape
            or labels.device != mask.device):
        raise ValueError("seg_scan_axis_cuda: labels must be int32 of the "
                         f"mask's shape and device, got "
                         f"{tuple(labels.shape)} {labels.dtype} on "
                         f"{labels.device}")
    dim = _axis_dim(dim)
    B, h, w = mask.shape
    mask, labels = mask.contiguous(), labels.contiguous()
    out = torch.empty_like(labels)
    agg_v, agg_b = _aggregates(mask)
    _build.launch("repas_seg_scan", mask.device, mask.data_ptr(),
                  labels.data_ptr(), out.data_ptr(), agg_v.data_ptr(),
                  agg_b.data_ptr(), B, h, w, int(dim == 2), COL_CHUNK)
    _build.launches["ccl_tiled"] += 1
    return out


def connected_components_tiled_cuda(mask: torch.Tensor, iters: int = 5,
                                    converge: bool = False) -> torch.Tensor:
    """Tiled CCL on the card: (B,H,W) bool mask -> (B,H,W) int32 labels,
    the band CCL in grid mode (`converge`: as ``ccl_cuda``'s)."""
    ccl_cuda.check_mask("connected_components_tiled_cuda", mask, iters)
    out = ccl_cuda.run_plan(mask, iters,
                            ccl_cuda.plan_for(mask, cluster_ok=False),
                            converge, ccl_cuda.COUNTER_B4)
    _build.launches["ccl_tiled"] += 1
    return out


def connected_components_tiled(mask: torch.Tensor, iters: int = 5,
                               converge: bool = False) -> torch.Tensor:
    """Tiled CCL: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if mask.is_cuda:
        return connected_components_tiled_cuda(mask, iters, converge)
    return connected_components_tiled_plain(mask, iters, converge)
