"""The program's spans and capture counter (``utils.profiling.span``,
``core.jit.CAPTURES``) and the benchmark's readers of them.

``register_clouds`` runs on a small pair on the CPU under a CPU-only
``torch.profiler``: it records its tree of stages and host reads, on the
profiler's clock, and nothing without a profiler. The readers
(``benchmark/metrics/entry_idle_ms.job.py``, ``host_wait_ms.job.py``,
``capture_s.py``) are fed a synthetic trace and synthetic spans. The one
test of the compiled-step wrapper's spans on the card is marked
``cuda``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.spec import Spec
from benchmark.trace import Trace
from repas_tpu_torch.cloud.registration import register_clouds
from repas_tpu_torch.core import jit as jit_mod
from repas_tpu_torch.utils import profiling
from repas_tpu_torch.utils.profiling import Span, clear_spans, span, spans

STAGES = ["reg.aabb", "reg.global", "reg.normals", "reg.icp"]
GLOBAL = ["reg.down", "reg.feat", "reg.down", "reg.feat", "reg.match",
          "reg.ransac"]
READS = {"read.aabb": "reg.aabb", "read.n_down": "reg.down",
         "read.ransac": "reg.ransac", "read.t_init": "reg.icp",
         "read.icp_iters": "reg.icp"}


@contextlib.contextmanager
def one_torch_thread():
    """torch's CPU ops on one thread for the block: the suite runs one
    worker process per core, and a thread pool per worker spins against
    the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pair(n=3000, seed=0):
    """A bumpy surface (tests/test_registration.py's) and a moved copy:
    (src, tgt, mask)."""
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(-0.5, 0.5, n),
                           rng.uniform(-0.5, 0.5, n),
                           np.zeros(n)]).astype(np.float32)
    pts[:, 2] = (0.08 * np.sin(7 * pts[:, 0]) * np.cos(5 * pts[:, 1])
                 + 0.05 * pts[:, 0] ** 2)
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = ((pts - np.float32([0.02, -0.01, 0.01])) @ R).astype(np.float32)
    return src, pts, np.ones(n, bool)


def _register(src, tgt, mask):
    return register_clouds(src, mask, tgt, mask, icp_iters=3,
                           device="cpu")


@pytest.fixture(scope="module")
def traced_call():
    """(spans, profiler events by label) of one register_clouds call
    under a CPU profile."""
    src, tgt, mask = _pair()
    clear_spans()
    with one_torch_thread():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _register(src, tgt, mask)
    recorded = spans()
    clear_spans()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    return recorded, events


def test_register_clouds_records_the_span_tree(traced_call):
    recorded, _ = traced_call
    by_id = {s.id: s for s in recorded}
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["reg.entry"]
    root = roots[0]
    assert root.attrs["n_src"] == root.attrs["n_tgt"] == 3000
    assert root.attrs["voxel"] > 1e-3

    def children(s):
        return [c.name for c in sorted(recorded, key=lambda c: c.start_ns)
                if c.parent == s.id and not c.name.startswith("read.")]

    assert children(root) == STAGES
    glob = next(s for s in recorded if s.name == "reg.global")
    assert children(glob) == GLOBAL
    reads = [s for s in recorded if s.name.startswith("read.")]
    assert sorted({s.name for s in reads}) == sorted(READS)
    assert len([s for s in reads if s.name == "read.n_down"]) == 2
    for r in reads:
        assert by_id[r.parent].name == READS[r.name]
    for s in recorded:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        assert s.job == root.id and s.thread == root.thread
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (
                s.name, p.name)


def test_no_profiler_records_nothing():
    src, tgt, mask = _pair(n=1500, seed=1)
    clear_spans()
    with one_torch_thread():
        _register(src, tgt, mask)
    assert spans() == []
    # off, every span site gets one shared no-op context
    assert span("a") is span("b", fn="f")


def test_spans_lie_on_the_profilers_clock(traced_call):
    recorded, events = traced_call
    used = {}
    for s in sorted(recorded, key=lambda s: s.start_ns):
        i = used[s.label] = used.get(s.label, -1) + 1
        e = events[s.label][i]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert abs(s.start_ns - start) <= 100_000, (s.name, s.start_ns - start)
        assert abs(s.end_ns - end) <= 100_000, (s.name, s.end_ns - end)


def test_a_span_is_a_host_op_in_the_profile():
    """A span's profiler event lies on the host, never on the device's
    track, where the benchmark's trace would count it as device work."""
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", fn="step") as outer:
            with span("inner") as inner:
                pass
    names = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "outer:step" in names and "inner" in names
    assert names["inner"].device_type() == torch.autograd.DeviceType.CPU
    assert inner.parent == outer.id and inner.job == outer.job == outer.id
    assert [s.label for s in spans()] == ["outer:step", "inner"]
    clear_spans()
    assert spans() == []


def test_the_span_list_is_bounded(monkeypatch):
    import collections

    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [s.name for s in spans()] == ["s2", "s3", "s4"]


def test_captures_are_counted_and_spanned(monkeypatch):
    monkeypatch.setattr(jit_mod, "CAPTURES", {})
    step = jit_mod.jit(lambda x: x + 1)
    monkeypatch.setattr(step, "_record", lambda *a: "graph")
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        assert step._capture(None, [], None) == "graph"
    assert step._capture(None, [], None) == "graph"

    def fail(*a):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(step, "_record", fail)
    with pytest.raises(RuntimeError):
        step._capture(None, [], None)
    # keyed by module and qualname: a `<lambda>` of another module is
    # another row
    assert step.full_name == f"{__name__}.{step.name}"
    n, sec = jit_mod.CAPTURES[step.full_name]
    assert n == 3 and sec >= 0
    assert [s.label for s in spans()] == [f"jit.capture:{step.full_name}"]
    clear_spans()


# the readers, on a synthetic trace: a window of 0-100 ms, 2 jobs, the
# device busy 10-30 and 60-70 ms
MS = 1_000_000


def _trace():
    tr = Trace(window=(0, 100 * MS), steps=2)
    tr.kernels = [("k", 10 * MS, 20 * MS), ("k", 60 * MS, 10 * MS)]
    return tr


def _span(i, name, start_ms, end_ms, parent=None):
    return Span(i, name, int(start_ms * MS), int(end_ms * MS), parent,
                i if parent is None else parent, 1, {})


SYNTHETIC = [
    # begins before the window: left out
    _span(0, "reg.entry", -5, 8),
    _span(1, "read.icp_iters", -3, 2, 0),
    # job 1: 5-40 ms, busy 20 of its 35: idle 15, 4 of it in a read of
    # 4 ms
    _span(2, "reg.entry", 5, 40),
    _span(3, "read.n_down", 30, 34, 2),
    # job 2: 50-90 ms, busy 10 of its 40: idle 30; reads of 2 ms (idle
    # 2) and 10 ms (busy 5, idle 5)
    _span(4, "reg.entry", 50, 90),
    _span(5, "read.ransac", 55, 57, 4),
    _span(6, "read.icp_iters", 65, 75, 4),
    # ends after the window: left out
    _span(7, "reg.entry", 95, 105),
]


@pytest.fixture()
def readers():
    spec = Spec()
    return {m: spec.reader(m) for m in ("entry_idle_ms.job",
                                        "host_wait_ms.job", "capture_s")}


def test_entry_idle_reader(readers, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SYNTHETIC)
    assert readers["entry_idle_ms.job"]({"trace": _trace()}) == \
        pytest.approx((15 - 4 + 30 - 2 - 5) / 2)


def test_entry_idle_leaves_out_idle_inside_reads(readers, monkeypatch):
    """A job whose device work the trace records only in part (a WHILE
    node's first trip): the host waits in a read while the trace shows
    the card idle. That idle is not the host's: the job reads 2 ms, the
    idle before the first kernel."""
    tr = Trace(window=(0, 100 * MS), steps=1)
    tr.kernels = [("k", 12 * MS, 8 * MS)]
    monkeypatch.setattr(profiling, "spans", lambda: [
        _span(0, "reg.entry", 10, 60),
        _span(1, "reg.icp", 10, 60, 0),
        _span(2, "read.icp_iters", 15, 60, 0)])
    assert readers["entry_idle_ms.job"]({"trace": tr}) == pytest.approx(2)
    assert readers["host_wait_ms.job"]({"trace": tr}) == pytest.approx(45)


def test_host_wait_reader(readers, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SYNTHETIC)
    assert readers["host_wait_ms.job"]({"trace": _trace()}) == \
        pytest.approx((4 + 2 + 10) / 2)


def test_capture_reader(readers, monkeypatch):
    monkeypatch.setattr(jit_mod, "CAPTURES", {"a": (2, 1.5), "b": (1, 0.25)})
    assert readers["capture_s"]({"trace": _trace()}) == pytest.approx(1.75)


@pytest.mark.parametrize("metric", ["entry_idle_ms.job", "host_wait_ms.job",
                                    "capture_s"])
def test_readers_find_nothing_in_a_program_without_spans(readers, metric,
                                                         monkeypatch):
    """The parent commit's program: no spans(), no CAPTURES; and a window
    that holds no span."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(jit_mod, "CAPTURES")
    assert readers[metric]({"trace": _trace()}) is None
    monkeypatch.undo()
    if metric != "capture_s":
        monkeypatch.setattr(profiling, "spans", lambda: SYNTHETIC[:2])
        assert readers[metric]({"trace": _trace()}) is None


@pytest.mark.cuda
def test_a_compiled_step_spans_its_capture_and_replays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    step = jit_mod.jit(lambda x: x * 2 + 1)
    x = torch.ones(64, device="cuda")
    before = jit_mod.CAPTURES.get(step.full_name, (0, 0.0))
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            y = step(x)
        torch.cuda.synchronize()
    assert torch.equal(y, x * 2 + 1)
    labels = [s.label for s in spans()]
    assert labels == [f"jit.capture:{step.full_name}"] + \
        [f"jit.replay:{step.full_name}"] * 3
    n, sec = jit_mod.CAPTURES[step.full_name]
    assert n == before[0] + 1 and sec > before[1]
    on_card = {e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert not any(lb in on_card for lb in labels)
    clear_spans()
