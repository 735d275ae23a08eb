"""The port's benchmark (repas_tpu_torch.bench) against the JAX package's
(bench.py, loaded from its file), on the CPU at small sizes: each
module's H, W and BATCH shrunk by monkeypatching.

Tolerances:
  * ``_frames`` equal to bench.py's bit for bit (240x320, batch 2);
  * ``bumpy_scene`` at n = 10,000: the target equal to bench.py's
    arrays, the source within 1e-6 m (bench.py rotates with the JAX
    package's rodrigues, the port with its own);
  * ``_record`` equal to bench.py's on the same inputs but for the four
    stated departures (registration_1m_wall_s, robust_real_fps null
    beside robust_synth_fps, device, cpu_fps_cached false);
  * the rest are checks of the port alone: the headline gate, the line
    order, the extras' records, the probes' lines, no card.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.core.transforms import rodrigues as j_rodrigues  # noqa: E402
from repas_tpu_torch import bench  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"H": 240, "W": 320, "BATCH": 2}


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def small(monkeypatch, jbench):
    for mod in (bench, jbench):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(bench, "ITERS", 2)


def _port_keys(keys):
    """bench.py's keys with the port's departures of form."""
    out = []
    for k in keys:
        out.append("registration_1m_wall_s" if k == "registration_1m_pts_s"
                   else k)
        if k == "robust_real_fps":
            out.append("robust_synth_fps")
    return out + ["device"]


def test_frames_bit_for_bit(small, jbench):
    for a, b in zip(bench._frames(2), jbench._frames(2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bumpy_scene_matches_reference():
    n = 10_000
    src, tgt, R, t = bench.bumpy_scene(n)
    # bench.py:226-236, at n points
    rng = np.random.default_rng(7)
    pts = np.column_stack([
        rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
        np.zeros(n)]).astype(np.float32)
    pts[:, 2] = (0.08 * np.sin(7 * pts[:, 0]) * np.cos(5 * pts[:, 1])
                 + 0.05 * pts[:, 0] ** 2)
    rv = np.array([0.04, -0.06, 0.30], np.float32)
    t_true = np.array([0.06, -0.04, 0.05], np.float32)
    R_ref = np.asarray(j_rodrigues(jnp.asarray(rv)))
    src_ref = ((pts - t_true) @ R_ref).astype(np.float32)
    np.testing.assert_array_equal(tgt, pts)
    np.testing.assert_array_equal(t, t_true)
    np.testing.assert_allclose(R, R_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(src, src_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["all", "headline", "failed"])
def test_record_matches_reference(jbench, case):
    fps = 187.3456
    args = {"all": (2.5123, 31.26, 7, 0.8765, 45.678, "ok"),
            "headline": (None, None, None, None, None, None),
            "failed": (1.25, None, None, None, None,
                       "exception=RuntimeError")}[case]
    cpu, robust, n, reg, ref, status = args
    want = jbench._record(fps, cpu, False, robust, n, reg, ref, status)
    got = bench._record(fps, cpu, robust, n, reg, ref, status,
                        device="NVIDIA H100 80GB HBM3, 700.00 W")
    assert list(got) == _port_keys(want)
    assert got.pop("device") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert got.pop("robust_synth_fps") == want["robust_real_fps"]
    assert got.pop("robust_real_fps") is None
    want.pop("robust_real_fps")
    assert got.pop("registration_1m_wall_s") == want.pop(
        "registration_1m_pts_s")
    assert got == want
    assert got["cpu_fps_cached"] is (False if cpu else None)


def test_time_pipeline_gates(small, monkeypatch):
    fps = bench._time_pipeline(2, 2, device="cpu")
    assert fps > 0

    frames = bench._frames

    def tagless_second_frame(batch):
        rgbs, depths, K = frames(batch)
        rgbs[1] = 180
        return rgbs, depths, K

    monkeypatch.setattr(bench, "_frames", tagless_second_frame)
    with pytest.raises(RuntimeError, match="bench gate.*-1"):
        bench._time_pipeline(2, 2, device="cpu")


def test_inference_mode_equals_no_grad(small):
    """The bench times the pipeline under torch.inference_mode(); its
    forward-mode LM gives what it gives under no_grad, before and after
    (the constant caches are shared by both modes)."""
    rgbs, depths, K = (torch.from_numpy(a) for a in bench._frames(2))
    run = lambda: bench.process_frames_jit(rgbs, depths, K)  # noqa: E731
    with torch.no_grad():
        before = run()
    with torch.inference_mode():
        inf = run()
    with torch.no_grad():
        after = run()
    for a, b, c in zip(before.pose, inf.pose, after.pose):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        torch.testing.assert_close(c, a, rtol=0, atol=0)
    assert torch.equal(inf.detections.ids, before.detections.ids)


def test_main_prints_the_headline_first(small, monkeypatch, capsys,
                                        jbench):
    monkeypatch.setenv("REPAS_BENCH_BUDGET_S", "0")
    bench.main(["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    head, last = lines
    keys = _port_keys(jbench._record(1.0, None, False, None, None))
    assert list(head) == keys and list(last) == keys
    assert head["metric"] == "detect_pnp_pointcloud_720p"
    assert head["value"] > 0 and head["device"] == "cpu"
    assert head["mpts_per_s"] == round(head["value"] * 240 * 320 / 1e6, 1)
    # a budget of 0 s runs no extra: every extra's field stays null
    assert last == head and head["cpu_fps"] is None


def test_main_records_the_extras(small, monkeypatch, capsys):
    monkeypatch.delenv("REPAS_BENCH_BUDGET_S", raising=False)
    monkeypatch.setattr(bench, "_probe", lambda flag, key, timeout: {
        "--cpu-probe": 1.5, "--ref-probe": 40.0}[flag])
    monkeypatch.setattr(bench, "_time_robust_ladder",
                        lambda dev: (31.25, 7))

    def broken(dev):
        raise ValueError("boom")

    monkeypatch.setattr(bench, "_time_registration_1m", broken)
    bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    head, last = (json.loads(x) for x in out.splitlines())
    assert head["cpu_fps"] is None
    assert last["value"] == head["value"]
    assert last["cpu_fps"] == 1.5 and last["cpu_fps_cached"] is False
    assert last["vs_baseline"] == round(last["value"] / 1.5, 2)
    assert last["robust_synth_fps"] == 31.25
    assert last["robust_real_fps"] is None
    assert last["robust_tags_found"] == 7
    assert last["registration_1m_wall_s"] is None
    assert last["registration_1m_status"] == "exception=ValueError"
    assert last["ref_stack_cpu_fps"] == 40.0
    failed = json.loads(err.strip().splitlines()[-1])
    assert failed == {"extra_failed": "reg1m", "exception": "ValueError",
                      "detail": "boom"}


def test_registration_extra(monkeypatch):
    monkeypatch.setattr(bench, "REG_N", 20_000)
    wall_s, status = bench._time_registration_1m("cpu")
    assert status == "ok" and wall_s > 0


def test_robust_ladder_extra(monkeypatch):
    frames = bench.robust_frames()[[0, 1]]
    monkeypatch.setattr(bench, "robust_frames", lambda: frames)
    monkeypatch.setattr(bench, "ROBUST_ITERS", 1)
    fps, n_found = bench._time_robust_ladder("cpu")
    assert fps > 0 and n_found == 2


def test_without_a_card_nothing_is_printed(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_cpu_probe_prints_one_line(small, monkeypatch, capsys):
    monkeypatch.setattr(bench, "CPU_MIN_S", 0.0)
    bench.main(["--cpu-probe"])
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line)["cpu_fps"] > 0


def test_ref_probe_prints_one_line(small, monkeypatch, capsys):
    pytest.importorskip("cv2")
    monkeypatch.setattr(bench, "REF_PROBE_S", 0.2)
    bench.main(["--ref-probe"])
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line)["ref_stack_cpu_fps"] > 0


def test_probe_failure_names_the_last_stderr_line():
    with pytest.raises(RuntimeError, match="exited 2.*unrecognized"):
        bench._probe("--no-such-flag", "cpu_fps", 120)
