"""The device rule of the port's entry points.

Entry points that take tensors run where their inputs lie. Entry points
that take host data (numpy frames from a stream, raw camera buffers)
run on the card unless the caller names another device; without a card
they raise rather than carry on on the CPU.
"""
from __future__ import annotations

import torch


def host_data_device(device=None) -> torch.device:
    """`device` (default: CUDA) as a torch.device; raises RuntimeError for
    a CUDA device when torch sees no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    return dev
