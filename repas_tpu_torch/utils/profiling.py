"""Profiling hooks (SURVEY.md §5.1): spans, the FPS counter, the trace.

Port of ``repas_tpu/utils/profiling.py``: ``FpsCounter`` copied;
``device_trace`` wraps ``torch.profiler`` where the reference wraps
``jax.profiler``. The reference's ``stage_timer`` (a host clock around a
stage, ended by waiting for the device) has no counterpart: ``span``
records the stages without waiting for anything.

``span(name, **attrs)`` marks a stretch of host code. While a
``torch.profiler`` profile runs (on any thread; ``device_trace`` starts
one), it opens a profiler event of the same name, so the profile's
timeline (``device_trace``'s Chrome trace) shows the program's stages
beside the kernels, and it appends a ``Span`` to a bounded in-memory
list (``spans()``, ``clear_spans()``): the name, start and end in ns on
the profiler's clock (Unix-epoch ns, ``time.time_ns()``, the base kineto
stamps its host and device events in), the enclosing span on the same
thread, the job (the sequence number of the outermost span it lies in),
the thread and the attrs. Otherwise it reads the profiler's flag,
returns a shared no-op context and records nothing. Nothing is written
to disk.

The event is a host op (``torch._C._profiler._RecordFunctionFast``, a
``cpu_op`` in the Chrome trace), not a ``record_function`` annotation:
the profiler copies an annotation onto the device's track, as an event
of the device that covers the kernels launched inside it, which a reader
of the device's events would count as device work. It also costs about
a tenth of one, and its ends lie within a few us of the span's.

The reference's ad-hoc FPS counters (capture_aligned_all.py:237-241,
rgbd_viewer.py:335-345 prints every second) become a reusable FpsCounter.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

from repas_tpu_torch.utils.logging import get_logger

log = get_logger("perf")

# the newest spans kept: a registration job records about 30, a traced
# benchmark stretch a few hundred
MAX_SPANS = 1 << 16

_spans = collections.deque(maxlen=MAX_SPANS)
_open = threading.local()       # .stack: this thread's open spans
_ids = itertools.count()


@dataclass
class Span:
    """One recorded span; `end_ns` is None while it is open. `parent` is
    the enclosing span's `Span.id`, None for an outermost one, whose `id`
    is also its `job`."""
    id: int
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    job: int
    thread: int
    attrs: dict = field(default_factory=dict)

    @property
    def label(self) -> str:
        """The span's name in the profiler's timeline: the name, and
        `:<fn>` after it where the span carries an `fn` attr."""
        fn = self.attrs.get("fn")
        return self.name if fn is None else f"{self.name}:{fn}"


class _Recording:
    """The context of a span while the profiler runs."""

    __slots__ = ("name", "attrs", "span", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        sid = next(_ids)
        parent = stack[-1] if stack else None
        s = self.span = Span(sid, self.name, 0, None,
                             None if parent is None else parent.id,
                             sid if parent is None else parent.job,
                             threading.get_ident(), self.attrs)
        self.rf = torch._C._profiler._RecordFunctionFast(s.label)
        self.rf.__enter__()
        # stamped after the profiler's own, each on its way out
        s.start_ns = time.time_ns()
        stack.append(s)
        _spans.append(s)
        return s

    def __exit__(self, *exc):
        _open.stack.pop()
        self.rf.__exit__(*exc)
        self.span.end_ns = time.time_ns()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """Context manager marking a stretch of host code as a span (module
    docstring): recorded while a ``torch.profiler`` profile runs, a read
    of the profiler's flag otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, attrs)


def spans() -> list:
    """The recorded spans, oldest first (at most MAX_SPANS)."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


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
