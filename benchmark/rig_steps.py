"""Rig-step cells: the compiled frame step, ``process_frames_jit``, under
``frames.FrameCell``'s closed loop, reported in seconds a step.

A step is one batch of the rig's frames, one a camera, through the
compiled step with its results on the host; ``job_s`` is the window's
seconds over the steps it completed. Set-up, the loop, the trace and the
check are ``FrameCell``'s. The traced run also reads the program's CCL
counter (``repas_tpu_torch.kernels.ccl_cuda.counts``: the rounds kernel
B1's images ran, summed, and its images) before and after it, outside
every timed loop; a program without the counter gives nothing there.
"""
from __future__ import annotations

import torch

from benchmark.frames import FrameCell


def ccl_counts():
    """B1's row of the program's CCL counter, or None for a program
    without it."""
    try:
        from repas_tpu_torch.kernels import ccl_cuda
    except ImportError:
        return None
    read = getattr(ccl_cuda, "counts", None)
    return None if read is None else read()["b1"]


class RigStepCell(FrameCell):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ccl_counts = None      # the counter's change over the trace

    def window(self, seconds: float) -> dict:
        with torch.inference_mode():
            frames, dt = self._closed(seconds=seconds)
        return {"job_s": dt * self.batch / frames}

    def trace(self):
        before = ccl_counts()
        tr = super().trace()
        after = ccl_counts()
        if before is not None and after is not None:
            self.ccl_counts = {k: after[k] - before[k] for k in after}
        return tr

    def context(self) -> dict:
        return dict(super().context(), ccl_counts=self.ccl_counts)
