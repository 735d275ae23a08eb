"""Batched Kabsch rotation from 3x3 cross-covariances (kernel K2,
``csrc/kabsch3.cu``).

``kabsch3(H)`` is R = V diag(1, 1, sign det(V U^T)) U^T for H = U S V^T,
what ``cloud.fpfh._kabsch`` computes from H. On CUDA tensors it launches
K2, which reads no status on the host (cuSOLVER's SVD does), so
RANSAC's step captures as a CUDA graph. On CPU tensors it runs its plain
version, ``torch.linalg.svd`` and ``torch.linalg.det``. K2 replaces no
TPU kernel: the JAX package calls ``jnp.linalg.svd`` inside its jitted
step.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels import _build


def kabsch3_plain(H: torch.Tensor) -> torch.Tensor:
    """Plain K2: the Kabsch rotations (...,3,3) of H (...,3,3)."""
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.mT
    d = torch.sign(torch.linalg.det(V @ U.mT))
    ones = torch.ones_like(d)
    return (V * torch.stack([ones, ones, d], dim=-1)[..., None, :]) @ U.mT


def kabsch3(H: torch.Tensor, sweeps: torch.Tensor | None = None
            ) -> torch.Tensor:
    """kabsch3_plain's result; on the card from K2 (float64 one-sided
    Jacobi without division, one thread per matrix, warp tiles of 32
    staged through shared memory; H (N,3,3) float32). `sweeps`, an (N,)
    int32 tensor on the card, receives each matrix's sweep count."""
    if not H.is_cuda:
        return kabsch3_plain(H)
    if H.dtype != torch.float32 or H.dim() != 3 or H.shape[1:] != (3, 3):
        raise ValueError(f"kabsch3: needs (N,3,3) float32; got "
                         f"{tuple(H.shape)} {H.dtype}")
    n = H.shape[0]
    if sweeps is not None and (sweeps.dtype != torch.int32
                               or tuple(sweeps.shape) != (n,)
                               or sweeps.device != H.device
                               or not sweeps.is_contiguous()):
        raise ValueError("kabsch3: sweeps must be a contiguous (N,) int32 "
                         "tensor on H's device")
    H = H.contiguous()
    R = torch.empty((n, 3, 3), dtype=torch.float32, device=H.device)
    if n:
        _build.launch("repas_kabsch3", H.device, H.data_ptr(), R.data_ptr(),
                      0 if sweeps is None else sweeps.data_ptr(), n)
        _build.launches["kabsch3"] += 1
    return R
