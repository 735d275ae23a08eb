"""CPU tests of the rig-step cell ``femto720.b16.max`` (``benchmark/
rig_steps.py``): what it reports, and the reader of ``ccl_rounds.frames``.

The run here uses a small camera (320x240), a batch of 4 and one or two
tags of 45-90 px at any turn, on the CPU, where the program runs its
plain path; the traced run needs a card and is not run here.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import rig_steps
from benchmark.frames import FrameCell
from benchmark.run import run_cell
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CELL = "femto720.b16.max"


def _tiny_root(tmp: Path) -> Path:
    """BENCHMARK.json as it is, its frame configuration at 320x240 and the
    cell's mix at a batch of 4; the references and readers are the real
    ones."""
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    (tmp / "benchmark" / "traffic").mkdir()
    for d in ("reference", "metrics"):
        (tmp / "benchmark" / d).symlink_to(BENCH / d)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    entry = next(c for c in doc["configs"] if c["name"] == cell["config"])
    cfg = spec.config(cell["config"])
    cfg["camera"].update(width=320, height=240, fx=300.0, fy=300.0,
                         cx=160.2, cy=119.7)
    (tmp / entry["file"]).write_text(json.dumps(cfg))
    t = spec.traffic(cell["traffic"])
    t.update(batch=4, pool_batches=2, tags_per_frame=[1, 2],
             tag_side_px=[45, 90], cloud_within=3, judge_batches=3)
    (tmp / "benchmark" / "traffic" / f"{cell['traffic']}.json").write_text(
        json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp


def _cell(spec: Spec):
    cell = spec.cell(CELL)
    traffic = spec.traffic(cell["traffic"])
    return rig_steps.RigStepCell(spec.config(cell["config"]), traffic, 5,
                                 "cpu", spec.reference(traffic["reference"]))


def test_the_cell_reports_job_s_setup_s_and_its_layers():
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    assert cell["config"] == "femto_bolt_720p_rig16" and cell["chips"] == 1
    assert spec.traffic(cell["traffic"])["driver"] == \
        "benchmark.rig_steps:RigStepCell"
    assert [m["name"] for m in spec.end_to_end(CELL)] == ["job_s",
                                                         "setup_s"]
    names = [m["name"] for m in spec.per_layer(CELL)]
    assert names == ["warm_call_s", "capture_s", "ccl_rounds.frames",
                     "kernels_per_step.frames", "device_idle_pct.frames",
                     "b1_ccl_roofline", "b3_pointcloud_roofline"]
    for m in spec.per_layer(CELL):
        assert callable(spec.reader(m["name"]))
        if m["name"] not in ("warm_call_s", "capture_s"):
            assert m["moves"] == "job_s"


def test_job_s_is_the_window_seconds_over_its_steps(tmp_path, monkeypatch):
    work = _cell(Spec(_tiny_root(tmp_path)))
    # a closed loop that completed 7 steps of 4 frames in 2.1 s
    monkeypatch.setattr(work, "_closed", lambda **kw: (7 * 4, 2.1))
    assert work.window(2.0) == {"job_s": pytest.approx(0.3)}


def test_ccl_rounds_reads_the_counters_change_over_the_trace(
        tmp_path, monkeypatch):
    spec = Spec(_tiny_root(tmp_path))
    work = _cell(spec)
    read = spec.reader("ccl_rounds.frames")
    reads = iter([{"rounds": 100, "images": 20, "calls": 2},
                  {"rounds": 100 + 7 * 32 + 9 * 32, "images": 84,
                   "calls": 6}])
    monkeypatch.setattr(rig_steps, "ccl_counts", lambda: next(reads))
    monkeypatch.setattr(FrameCell, "trace", lambda self: "trace")
    assert work.trace() == "trace"
    ctx = work.context()
    assert ctx["ccl_counts"] == {"rounds": 512, "images": 64, "calls": 4}
    assert read(ctx) == 8.0
    # a program without the counter, or a trace without B1: nothing
    monkeypatch.setattr(rig_steps, "ccl_counts", lambda: None)
    work = _cell(spec)
    work.trace()
    assert read(work.context()) is None
    assert read({"ccl_counts": {"rounds": 0, "images": 0,
                                "calls": 0}}) is None


def test_the_counter_reads_zero_where_no_kernel_ran():
    # on the CPU the program builds no kernel: the counter is all zeros
    assert rig_steps.ccl_counts() == {"rounds": 0, "images": 0, "calls": 0}


def test_a_short_run_on_the_cpu_is_correct(tmp_path):
    spec = Spec(_tiny_root(tmp_path))
    r = run_cell(spec, spec.cell(CELL), 2 ** 40 + 17, 0.5, False, "cpu")
    assert set(r["metrics"]) == {"job_s", "setup_s"}
    assert r["metrics"]["job_s"]["value"] > 0 and r["attempted"] > 0
    assert r["correct"], r["checks"]
    assert r["checks"]["tags_wrong"]["value"] == 0
