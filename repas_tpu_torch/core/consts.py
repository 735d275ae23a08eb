"""Small constant tensors on the device, copied from the host once.

``torch.tensor(values, device=cuda)`` copies from pageable host memory
and waits for the stream, so building a constant inside the frame step
would stall the host on every call. ``const`` keeps one copy per
(values, dtype, device); from the second step on, the step issues no
blocking host-to-device copy. Callers must not modify the result. A
CUDA graph captured by ``core.jit`` pins the constants it reads, so an
evicted constant stays alive while a graph reads it.
"""
from __future__ import annotations

import functools

import torch

from repas_tpu_torch.core.jit import pin


@functools.lru_cache(maxsize=256)
def _cached(values: tuple, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """The constant tensor of (nested) tuple `values` on `device`."""
    return pin(_cached(values, dtype, torch.device(device)))
