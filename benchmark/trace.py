"""A traced window: ``torch.profiler`` over a fixed amount of the cell's
own work, reduced to device intervals.

The host marks what it does with ``torch.profiler.record_function``
labels (``bench.window`` around the whole window; ``bench.dispatch``,
``bench.wait`` and the like inside), so an idle stretch of the device is
named by the host activity that covers its start.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

# the trace drops device events stamped before its window opened (seen
# on the H100: a replay's first kernels, now and then), so the work
# starts well inside it
MARGIN_S = 0.2


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start_ns, dur_ns)
    copies: list = field(default_factory=list)    # memcpy / memset
    host: list = field(default_factory=list)      # (label, start_ns, end_ns)
    window: tuple = (0, 0)                         # ns
    steps: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list:
        """Merged device intervals inside the window."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(s + d, hi))
                    for _, s, d in self.kernels + self.copies
                    if s + d > lo and s < hi)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def idle_gaps(self) -> list:
        """(label, seconds) of each idle stretch of the window, named by
        the innermost host label covering its start."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = []
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                gaps.append((self.label_at(s), (e - s) * 1e-9))
        return gaps

    def label_at(self, ns: int) -> str:
        best, width = "host", None
        for label, s, e in self.host:
            if s <= ns < e and (width is None or e - s < width):
                best, width = label, e - s
        return best

    def breakdown(self) -> dict:
        by_name = {}
        for name, s, d in self.kernels + self.copies:
            by_name[name] = by_name.get(name, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:10]
        return {"device_ops": [[n[:160], d * 1e-9] for n, d in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)


def _dur_ns(e) -> int:
    return (e.duration_ns() if hasattr(e, "duration_ns")
            else int(e.duration_us() * 1e3))


def traced(work, mark: bool = True) -> Trace:
    """Runs work() -> steps under the profiler and returns its Trace. With
    `mark` the whole of work() is the window (a ``bench.window`` label
    around it); without, work() labels its own window (a loop that
    primes its queue first). work() ends with the device idle."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        if mark:
            with record_function("bench.window"):
                steps = work()
                torch.cuda.synchronize()
        else:
            steps = work()
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    tr = Trace(steps=steps)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, s, d = e.name(), _start_ns(e), _dur_ns(e)
        if name.startswith("bench."):
            # the host's labels; their copies on the device track
            # (annotations, no work) are left out
            if e.device_type() == cuda:
                continue
            if name == "bench.window":
                tr.window = (s, s + d)
            else:
                tr.host.append((name, s, s + d))
        elif e.device_type() == cuda:
            (tr.copies if name.startswith(("Memcpy", "Memset"))
             else tr.kernels).append((name, s, d))
    if tr.window == (0, 0):
        raise RuntimeError("the trace holds no bench.window event")
    return tr
