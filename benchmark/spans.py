"""The program's spans (``repas_tpu_torch.utils.profiling.span``) inside a
traced window, and its capture counter (``core.jit.CAPTURES``), for the
per-layer metrics that read them. A program without them gives [] and
{}.
"""
from __future__ import annotations


def window_spans(trace, prefix: str = "") -> list:
    """The program's closed spans whose name starts with `prefix` and
    which lie inside the trace's window; [] for a program without
    spans."""
    try:
        from repas_tpu_torch.utils import profiling
    except ImportError:
        return []
    get = getattr(profiling, "spans", None)
    if get is None:
        return []
    lo, hi = trace.window
    return [s for s in get() if s.name.startswith(prefix)
            and s.end_ns is not None and lo <= s.start_ns
            and s.end_ns <= hi]


def busy_ns(busy: list, start: int, end: int) -> int:
    """Device-busy ns inside [start, end] of `busy`, the trace's merged
    intervals (``Trace.busy_intervals()``)."""
    return sum(max(0, min(e, end) - max(s, start)) for s, e in busy)


def idle_ns(busy: list, s) -> int:
    """Device-idle ns inside span `s`."""
    return s.end_ns - s.start_ns - busy_ns(busy, s.start_ns, s.end_ns)


def captures() -> dict:
    """The program's capture counter (``core.jit.CAPTURES``): captures
    and seconds, summed; {} for a program without it."""
    try:
        from repas_tpu_torch.core import jit
    except ImportError:
        return {}
    caps = getattr(jit, "CAPTURES", None)
    if caps is None:
        return {}
    return {"count": sum(n for n, _ in caps.values()),
            "seconds": sum(s for _, s in caps.values())}
