"""Batched symmetric 9x9 eigendecomposition (kernel K3,
``csrc/eig9.cu``).

``eig9`` has ``torch.linalg.eigh``'s contract on (N,9,9) float32 or
float64 matrices: eigenvalues ascending (N,9), eigenvectors as columns
(N,9,9), in the input's type, from the lower triangle. On CUDA tensors
it launches K3, which reads no status on the host (cuSOLVER's eigh reads
one after every call), so SQPnP's step captures as a CUDA graph. On CPU
tensors it runs its plain version, ``torch.linalg.eigh`` (LAPACK). K3
replaces no TPU kernel: the JAX package calls ``jnp.linalg.eigh`` and
``jnp.linalg.svd`` inside its jitted ``solve_pnp_sqpnp``.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels import _build


def eig9_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K3: (eigenvalues (N,9) ascending, eigenvectors (N,9,9) as
    columns) of symmetric A (N,9,9)."""
    return torch.linalg.eigh(A)


def eig9(A: torch.Tensor, sweeps: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """eig9_plain's result; on the card from K3 (float64 Jacobi in
    round-robin order, three matrices a warp, a lane a row). `sweeps`, an
    (N,) int32 tensor on the card, receives each matrix's Jacobi sweep
    count."""
    if not A.is_cuda:
        return eig9_plain(A)
    if A.dtype not in (torch.float32, torch.float64) or A.dim() != 3 \
            or A.shape[1:] != (9, 9):
        raise ValueError(f"eig9: needs (N,9,9) float32 or float64; got "
                         f"{tuple(A.shape)} {A.dtype}")
    n = A.shape[0]
    if sweeps is not None and (sweeps.dtype != torch.int32
                               or tuple(sweeps.shape) != (n,)
                               or sweeps.device != A.device
                               or not sweeps.is_contiguous()):
        raise ValueError("eig9: sweeps must be a contiguous (N,) int32 "
                         "tensor on A's device")
    A = A.contiguous()
    w = torch.empty((n, 9), dtype=A.dtype, device=A.device)
    V = torch.empty((n, 9, 9), dtype=A.dtype, device=A.device)
    if n:
        _build.launch("repas_eig9", A.device, A.data_ptr(), w.data_ptr(),
                      V.data_ptr(),
                      0 if sweeps is None else sweeps.data_ptr(), n,
                      int(A.dtype == torch.float64))
        _build.launches["eig9"] += 1
    return w, V
