"""CPU tests of the benchmark harness: imports, seeded inputs, the trace
arithmetic, discovery by name, the result line, and that the check
fails the bfloat16 control and a program whose answers are altered.

The runs here use a small camera (320x240) and batch (4) on the CPU,
where the program runs its plain path; the one test of the real command
on the card is marked ``cuda``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.counts import ccl_bound_s, pointcloud_bound_s
from benchmark.run import FORBIDDEN, run_cell
from benchmark.spec import Spec
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def with_held_back(doc: dict) -> dict:
    """`doc` with the entries of ``benchmark/held_back.json`` added: the
    frame cells, their configuration and their metrics (a metric both
    name gets the cells of both)."""
    held = json.loads((BENCH / "held_back.json").read_text())
    doc = json.loads(json.dumps(doc))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"]: e for e in doc[key]}
        for e in held[key]:
            if e["name"] in have:
                have[e["name"]]["workloads"] += e["workloads"]
            else:
                doc[key].append(e)
    return doc


def _tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark's data at a test's size, the held-back
    frame cells with it: each frame configuration at 320x240, each frame
    mix at a batch of 4 and one or two tags of 45-90 px, registration at
    20,000 points and 2 pairs; the references and metric readers are the
    real ones."""
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    (tmp / "benchmark" / "traffic").mkdir()
    for d in ("reference", "metrics"):
        (tmp / "benchmark" / d).symlink_to(BENCH / d)
    doc = with_held_back(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for c in doc["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["camera"].update(width=320, height=240, fx=300.0, fy=300.0,
                             cx=160.2, cy=119.7)
        if "registration" in cfg:
            cfg["registration"]["points"] = 20_000
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for name in {w["traffic"] for w in doc["workloads"]}:
        t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        if t["kind"] == "closed_jobs":
            t.update(pool_pairs=2)
        else:
            t.update(batch=4, pool_batches=2, tags_per_frame=[1, 2],
                     tag_side_px=[45, 90], cloud_within=3, judge_batches=3)
        if t["kind"] == "open_frames":
            t["rate_hz"] = 2
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp


@pytest.fixture()
def tiny(tmp_path):
    return Spec(_tiny_root(tmp_path))


def test_a_rehearsal_loads_no_jax_and_the_reference_nothing_of_the_program(
        tmp_path):
    root = _tiny_root(tmp_path)
    code = f"""
import json, sys
from benchmark.run import run_cell, forbidden_modules
from benchmark.spec import Spec
spec = Spec({str(root)!r})
run_cell(spec, spec.cell("femto720.b16.max"), 7, 0.5, False, "cpu")
for m in spec.doc["per_layer"]:
    spec.reader(m["name"])
print(json.dumps(forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []
    code = """
import sys
from benchmark.spec import Spec
from benchmark.run import FORBIDDEN
Spec().reference("frames")
import benchmark.scene
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & (set(FORBIDDEN) | {"repas_tpu_torch"})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names():
    assert "repas_tpu" in FORBIDDEN and "jax" in FORBIDDEN
    assert "repas_tpu_torch".split(".")[0] not in FORBIDDEN


def test_seeded_frames_repeat_and_differ_across_seeds(tiny):
    cfg = tiny.config("femto_bolt_720p")
    traffic = tiny.traffic("b16.max")
    cam = scene.Camera.from_config(cfg)

    def make(seed):
        rng = np.random.default_rng(seed)
        truth = scene.draw_frames(rng, cam, traffic, 0.0303, 16, 4)
        gen = torch.Generator()
        gen.manual_seed(seed)
        return truth, scene.render(truth, cam, 0.0303, gen, "cpu")

    (ta, (ra, da)), (tb, (rb, db)) = make(2 ** 40 + 3), make(2 ** 40 + 3)
    _, (rc, dc) = make(5)
    assert torch.equal(ra, rb) and torch.equal(da, db)
    assert [f.ids for f in ta] == [f.ids for f in tb]
    assert not torch.equal(ra, rc)
    # the same number of tags for every seed, the anchor in every frame
    assert sum(len(f.ids) for f in ta) == sum(
        len(f.ids) for f in make(9)[0])
    assert all(16 in f.ids for f in ta)


def test_truth_corners_follow_the_lens():
    cam = scene.Camera(640, 480, np.array([[600.0, 0, 320], [0, 600, 240],
                                           [0, 0, 1]]), None)
    lens = scene.Camera(640, 480, cam.K, np.array([0.1, -0.2, 0, 0, 0.05,
                                                   0, 0, 0]))
    fr = scene.Frame([16], [np.eye(3)], [np.array([0.05, 0.02, 0.4])],
                     np.array([0, 0, 1.0]), 1.0)
    a = scene.truth_corners(fr, cam, 0.0303)[0]
    b = scene.truth_corners(fr, lens, 0.0303)[0]
    x = (a[:, 0] - 320) / 600
    y = (a[:, 1] - 240) / 600
    xd, yd = scene.distort(x, y, lens.dist)
    np.testing.assert_allclose(b, np.stack([600 * xd + 320, 600 * yd + 240],
                                           -1), atol=1e-9)
    xu, yu = scene.undistort(xd, yd, lens.dist)
    np.testing.assert_allclose(np.stack([xu, yu], -1), np.stack([x, y], -1),
                               atol=1e-12)


def _trace():
    tr = Trace(window=(0, 10_000_000), steps=2)
    # two steps: B1, B3, one other kernel each; a copy; idle stretches
    tr.kernels = [("void (anonymous namespace)::ccl_band<ClusterScope, 20>",
                   1_000_000, 100_000),
                  ("(anonymous namespace)::pointcloud(unsigned short const*)",
                   1_100_000, 200_000),
                  ("gemm", 1_300_000, 2_700_000),
                  ("void (anonymous namespace)::ccl_band<ClusterScope, 20>",
                   5_000_000, 100_000),
                  ("(anonymous namespace)::pointcloud(unsigned short const*)",
                   5_100_000, 200_000),
                  ("gemm", 5_300_000, 2_700_000)]
    tr.copies = [("Memcpy DtoH (Device -> Pinned)", 3_900_000, 200_000)]
    tr.host = [("bench.dispatch", 0, 1_000_000),
               ("bench.wait", 4_100_000, 5_000_000)]
    return tr


def test_trace_arithmetic():
    tr = _trace()
    # busy: [1.0, 4.1] and [5.0, 8.0] ms
    assert tr.busy_s() == pytest.approx(6.1e-3)
    gaps = sorted(tr.idle_gaps(), key=lambda g: -g[1])
    assert gaps[0] == ("host", pytest.approx(2e-3))
    assert ("bench.dispatch", pytest.approx(1e-3)) in gaps
    assert ("bench.wait", pytest.approx(0.9e-3)) in gaps
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gemm", pytest.approx(5.4e-3)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_metric_readers_on_a_synthetic_trace(tiny):
    cfg = tiny.config("femto_bolt_720p")
    ctx = {"trace": _trace(), "batch": 4, "height": 720, "width": 1280,
           "config": cfg, "warm_call_s": 1.5, "send_lags_s": [0.001] * 19
           + [0.004]}
    read = {m["name"]: tiny.reader(m["name"]) for m in tiny.doc["per_layer"]}
    assert read["kernels_per_step.frames"](dict(ctx, replays=2)) == 3.0
    assert read["kernels_per_job.job"](ctx) == 3.0
    assert read["device_idle_pct.frames"](ctx) == pytest.approx(39.0)
    px = 4 * 360 * 640
    assert read["b1_ccl_roofline"](ctx) == pytest.approx(
        100 * 2 * ccl_bound_s(px, 5) / 200e-6)
    assert read["b3_pointcloud_roofline"](ctx) == pytest.approx(
        100 * 2 * pointcloud_bound_s(4 * 720 * 1280) / 400e-6)
    assert read["step_device_ms.rig"](ctx) == pytest.approx(3.05)
    assert read["send_lag_p95_ms.rig"](ctx) == pytest.approx(
        1e3 * np.percentile([0.001] * 19 + [0.004], 95))
    assert read["warm_call_s"](ctx) == 1.5
    # a reader that finds nothing returns nothing
    empty = dict(ctx, trace=Trace(window=(0, 1), steps=1))
    assert read["b1_ccl_roofline"](empty) is None
    assert read["b3_pointcloud_roofline"](empty) is None


def test_kernels_per_step_counts_the_replays_outside_the_window(tiny):
    # a closed loop's trace: replay 0 completes as the window opens,
    # replays 1-2 inside it, replay 3 drained after it closes; 5 kernels
    # each
    tr = Trace(window=(10_000, 30_000), steps=2)
    tr.kernels = [(f"k{j}", r * 10_000 + 1_000 * j, 500)
                  for r in range(4) for j in range(5)]
    read = tiny.reader("kernels_per_step.frames")
    assert read({"trace": tr, "replays": 4}) == 5.0
    assert read({"trace": tr, "replays": 0}) is None


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path
    (root / "benchmark" / "configs").mkdir(parents=True)
    (root / "benchmark" / "traffic").mkdir()
    (root / "benchmark" / "metrics").mkdir()
    (root / "benchmark" / "configs" / "cam_x.json").write_text(
        json.dumps({"camera": {"width": 8}}))
    (root / "benchmark" / "traffic" / "mix.y.json").write_text(
        json.dumps({"kind": "closed_frames", "batch": 3}))
    (root / "benchmark" / "metrics" / "thing_z.y.py").write_text(
        "def read(ctx):\n    return ctx['n'] * 2\n")
    doc = {"configs": [{"name": "cam_x", "file":
                        "benchmark/configs/cam_x.json", "reduced": []}],
           "workloads": [{"name": "cam_x.mix.y", "config": "cam_x",
                          "traffic": "mix.y", "chips": 1}],
           "end_to_end": [{"name": "frames_per_s", "workloads":
                           ["cam_x.mix.y"]}, {"name": "setup_s"}],
           "per_layer": [{"name": "thing_z.y", "moves": "frames_per_s",
                          "unit": "x", "workloads": ["cam_x.mix.y"]},
                         {"name": "other", "moves": "job_s", "unit": "x",
                          "workloads": ["cam_z.job"]}]}
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = Spec(root)
    cell = spec.cell("cam_x.mix.y")
    assert spec.config(cell["config"]) == {"camera": {"width": 8}}
    assert spec.traffic(cell["traffic"])["batch"] == 3
    assert [m["name"] for m in spec.end_to_end("cam_x.mix.y")] == [
        "frames_per_s", "setup_s"]
    assert [m["name"] for m in spec.per_layer("cam_x.mix.y")] == ["thing_z.y"]
    assert spec.reader("thing_z.y")({"n": 4}) == 8
    with pytest.raises(KeyError):
        spec.cell("nope")


def test_every_named_file_exists():
    spec = Spec(ROOT)
    spec.doc = with_held_back(spec.doc)
    for w in spec.doc["workloads"]:
        cfg = spec.config(w["config"])
        spec.reference(spec.traffic(w["traffic"])["reference"])
        assert cfg["limits"]
        assert spec.per_layer(w["name"])
    for m in spec.doc["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_result_keys_and_a_sound_run_is_correct(tiny):
    r = run_cell(tiny, tiny.cell("femto720.register"), 11, 1.0, False, "cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"job_s", "setup_s"}
    assert r["device"]["count"] == 1 and r["attempted"] > 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell, fails", [
    ("femto720.b16.max", {"cloud_mm", "tag_fit_px", "anchor_mm"}),
    ("d415_480.b16.max", {"cloud_mm", "tag_fit_px", "anchor_mm"}),
    ("femto720.register", {"reg_t_mm", "reg_R_deg"})])
def test_the_bfloat16_control_is_not_correct(tiny, cell, fails):
    r = run_cell(tiny, tiny.cell(cell), 12, 0.5, False, "cpu", control=True)
    assert not r["correct"]
    bad = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert fails <= bad, r["checks"]


def _altered(field):
    """process_frames with one answer altered where it is produced."""
    from repas_tpu_torch import pipeline

    real = pipeline.process_frames_jit

    def step(*a, **k):
        out = real(*a, **k)
        det, pose = out.detections, out.pose
        if field == "corners":
            det = det._replace(corners=det.corners + 3.0)
        elif field == "turned":     # each tag's corners one place on
            det = det._replace(corners=det.corners.roll(1, dims=-2))
        elif field == "ids":
            det = det._replace(ids=torch.where(det.ids == 16, 17, det.ids))
        elif field == "t":
            pose = pose._replace(t=pose.t * 1.02)
        elif field == "R_avg":
            pose = pose._replace(R_avg=pose.R_avg.flip(-1))
        elif field == "anchor":
            pose = pose._replace(anchor_P_depth=pose.anchor_P_depth + 1e-3)
        elif field == "cloud":
            return out._replace(detections=det, pose=pose,
                                pointcloud=out.pointcloud * 1.0001)
        return out._replace(detections=det, pose=pose)

    return step


@pytest.mark.parametrize("field, number", [
    ("corners", "corner_tag_px"), ("ids", "anchor_wrong"), ("t", "tag_fit_px"),
    ("R_avg", "fused_R_deg"), ("anchor", "anchor_mm"), ("cloud", "cloud_mm"),
    ("turned", "corner_tag_px")])
def test_an_altered_answer_is_not_correct(tiny, monkeypatch, field, number):
    # the number that judges the altered answer reads over its limit,
    # whatever the detector missed in the same frames
    from repas_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "process_frames_jit", _altered(field))
    r = run_cell(tiny, tiny.cell("femto720.b16.max"), 13, 0.5, False, "cpu")
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], \
        r["checks"]


@pytest.mark.parametrize("part", ["t", "R", "unmoved"])
def test_an_altered_transform_is_not_correct(tiny, monkeypatch, part):
    from repas_tpu_torch.cloud import registration

    real = registration.register_clouds

    def entry(*a, **k):
        res, fit, voxel = real(*a, **k)
        T = res.T.clone()
        if part == "t":
            T[:3, 3] += 1e-4
        elif part == "unmoved":     # the source returned where it lay
            T = torch.eye(4, dtype=T.dtype)
        else:
            c, s = np.cos(1e-4), np.sin(1e-4)
            T[:3, :3] = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1.0]],
                                     dtype=T.dtype) @ T[:3, :3]
        return res._replace(T=T), fit, voxel

    monkeypatch.setattr(registration, "register_clouds", entry)
    r = run_cell(tiny, tiny.cell("femto720.register"), 14, 0.5, False, "cpu")
    assert not r["correct"], r["checks"]


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "femto720.register", "--seed", "1", "--seconds",
                          "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_refuses_to_run_without_the_program(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(BENCH, tmp_path / "benchmark")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "femto720.register", "--seed", "1", "--seconds",
                          "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "femto720.register", "--seed", "4242424242",
                          "--seconds", "2"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
