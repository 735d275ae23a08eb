"""Float32 precision policy (port of the matmul-precision line in
``repas_tpu/__init__.py``).

Geometry code (homographies, PnP, rotation averaging) needs true f32
products. PyTorch's f32 matmul is full precision by default, but cuDNN's
f32 convolutions default to TF32 (about three decimal digits), so both
switches are set explicitly, as the reference forces
``jax_default_matmul_precision="highest"``.
"""
from __future__ import annotations

import contextlib

import torch


def set_precision_policy() -> None:
    """Force full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def cusolver(dev: torch.device):
    """cuSOLVER for the linear algebra on a CUDA device: the default
    heuristic may route a small solve to MAGMA, which synchronises."""
    if dev.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
