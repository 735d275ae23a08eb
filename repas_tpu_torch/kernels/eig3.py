"""Batched symmetric 3x3 eigendecomposition (kernel K1,
``csrc/eig3.cu``).

``eig3`` has ``torch.linalg.eigh``'s contract on (N,3,3) float32
matrices: eigenvalues ascending (N,3), eigenvectors as columns (N,3,3),
from the lower triangle. On CUDA tensors it launches K1, which reads no
status on the host and takes any N (cuSOLVER's eigh reads one after every
call and refuses 32,768 matrices or more), so the normals' steps capture
as CUDA graphs. On CPU tensors it runs its plain version,
``torch.linalg.eigh`` (LAPACK). K1 replaces no TPU kernel: the JAX
package calls ``jnp.linalg.eigh`` inside its jitted steps.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels import _build


def eig3_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: (eigenvalues (N,3) ascending, eigenvectors (N,3,3) as
    columns) of symmetric A (N,3,3)."""
    return torch.linalg.eigh(A)


def eig3(A: torch.Tensor, sweeps: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """eig3_plain's result; on the card from K1 (float64 cyclic Jacobi,
    one thread per matrix, staged through shared memory in 16-byte
    vectors). `sweeps`, an (N,) int32 tensor on the card, receives each
    matrix's Jacobi sweep count."""
    if not A.is_cuda:
        return eig3_plain(A)
    if A.dtype != torch.float32 or A.dim() != 3 or A.shape[1:] != (3, 3):
        raise ValueError(f"eig3: needs (N,3,3) float32; got "
                         f"{tuple(A.shape)} {A.dtype}")
    n = A.shape[0]
    if sweeps is not None and (sweeps.dtype != torch.int32
                               or tuple(sweeps.shape) != (n,)
                               or sweeps.device != A.device
                               or not sweeps.is_contiguous()):
        raise ValueError("eig3: sweeps must be a contiguous (N,) int32 "
                         "tensor on A's device")
    A = A.contiguous()
    w = torch.empty((n, 3), dtype=torch.float32, device=A.device)
    V = torch.empty((n, 3, 3), dtype=torch.float32, device=A.device)
    if n:
        _build.launch("repas_eig3", A.device, A.data_ptr(), w.data_ptr(),
                      V.data_ptr(),
                      0 if sweeps is None else sweeps.data_ptr(), n)
        _build.launches["eig3"] += 1
    return w, V
