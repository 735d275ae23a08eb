"""Profiling hooks (SURVEY.md §5.1).

Port of ``repas_tpu/utils/profiling.py``: ``FpsCounter`` copied;
``stage_timer`` waits for the sync object's CUDA device with
``torch.cuda.synchronize`` where the reference calls
``jax.block_until_ready``; ``device_trace`` wraps ``torch.profiler``
where the reference wraps ``jax.profiler``.

The reference's ad-hoc FPS counters (capture_aligned_all.py:237-241,
rgbd_viewer.py:335-345 prints every second) become a reusable FpsCounter;
per-stage timing wraps torch.profiler traces when enabled.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from repas_tpu_torch.utils.logging import get_logger

log = get_logger("perf")


def _cuda_devices(obj) -> set:
    """The CUDA devices of every tensor in `obj` (nested tuples, lists,
    dicts and NamedTuples)."""
    if torch.is_tensor(obj):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in obj)) if obj else set()
    return set()


@contextlib.contextmanager
def stage_timer(name: str, sync=None):
    """Wall-time a pipeline stage; pass `sync`, the stage's output (or a
    callable returning it), for accurate device timing: the timer then
    waits for every CUDA device that output lies on (a no-op for CPU
    tensors)."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        for dev in _cuda_devices(sync() if callable(sync) else sync):
            torch.cuda.synchronize(dev)
    log.info("%s: %.2f ms", name, (time.perf_counter() - t0) * 1e3)


class FpsCounter:
    """Rolling frames/sec, reported every `interval` seconds."""

    def __init__(self, interval: float = 1.0, tag: str = "fps"):
        self.interval = interval
        self.tag = tag
        self._n = 0
        self._t0 = time.perf_counter()
        self.fps = 0.0

    def tick(self, n: int = 1) -> float | None:
        self._n += n
        dt = time.perf_counter() - self._t0
        if dt >= self.interval:
            self.fps = self._n / dt
            self._n = 0
            self._t0 = time.perf_counter()
            log.info("%s: %.1f frames/sec", self.tag, self.fps)
            return self.fps
        return None


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """torch.profiler trace of the block (no-op when logdir is None):
    CPU activity, and CUDA activity where torch sees a card, written as a
    Chrome trace `trace.json` into logdir."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
