"""The compiled loops of the port (repas_tpu_torch/core/jit.py's
while_loop) and the steps compiled with them: the robust ladder's waves,
the calibration LM's step and the sharded step, one compiled function
per shard.

On the CPU a compiled step runs its function and ``while_loop`` reads its
condition on the host, so these tests check the loop against a Python
loop, its bound and its warm-up, and, over random wave problems
(hypothesis), that the ladder's real wave selection ends within
ceil(N / k) trips and that ``max_trips`` trips each gated by the
condition (what a captured graph runs) give the unbounded loop's state;
the same on the ladder itself at 96x128 (stages B and C 2 waves each,
of 3).
The LM replayed step by step is bit-equal to the loop it replaced and
agrees with the JAX package's ``calibrate_camera`` within
tests/test_torch_calib.py's noise-free tolerances (f, c 0.01 px; k1, k2
1e-3; RMS 1e-5 px). No ladder against the JAX package here: its compile
alone takes 12-22 s at 96x128 on the CPU, over this file's 20 s budget;
tests/test_torch_robust.py holds the ladder, waves and all, against it.

The ``cuda``-marked tests skip without a card. On one:
``python -m pytest -m cuda tests/test_torch_jit_loops.py``: the captured
ladder equals the eager one on a batch whose stages B and C take two
waves or more (taken and skipped conditional bodies), and two shards'
graphs replay side by side, neither waiting for the other.
"""
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repas_tpu_torch.calib import checkerboard as PC  # noqa: E402
from repas_tpu_torch.core import jit as jit_module  # noqa: E402
from repas_tpu_torch.core.config import DetectorConfig  # noqa: E402
from repas_tpu_torch.core.jit import Jitted, while_loop  # noqa: E402
from repas_tpu_torch.detect import robust  # noqa: E402
from repas_tpu_torch.detect.detector import Detections  # noqa: E402
from repas_tpu_torch.detect.render import render_tag  # noqa: E402
from repas_tpu_torch.parallel import (frames_mesh, shard_batch,  # noqa
                                      sharded_frame_pipeline)
from test_torch_scenes import synth_views  # noqa: E402
from test_torch_stream_scenes import one_torch_thread  # noqa: E402

D = 3                                   # detection slots of the fakes
LADDER_CFG = DetectorConfig(max_components=8, max_detections=4, ccl_iters=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one CPU thread: the suite runs a worker per core, and
    the ladder on a thread pool per worker took 250 s against 2 s."""
    with one_torch_thread():
        yield


def _count(x, i):
    return x * 2.0 + 1.0, i + 1


@pytest.mark.parametrize("n", [0, 1, 5])
def test_while_loop_equals_python_loop(n):
    x0 = torch.arange(4, dtype=torch.float32)
    tests = []
    x, i = while_loop(lambda s: s[1] < n, lambda s: _count(*s),
                      (x0, torch.tensor(0)), max_trips=5,
                      on_test=lambda: tests.append(1))
    want = x0
    for _ in range(n):
        want = want * 2.0 + 1.0
    assert torch.equal(x, want) and int(i) == n
    assert len(tests) == n + 1          # one host read per condition test


def test_while_loop_raises_past_max_trips():
    with pytest.raises(RuntimeError, match="max_trips=3"):
        while_loop(lambda s: s[1] < 4, lambda s: _count(*s),
                   (torch.zeros(2), torch.tensor(0)), max_trips=3)


def test_while_loop_rejects_a_body_that_changes_the_state():
    with pytest.raises(ValueError, match="structure, shapes or dtypes"):
        while_loop(lambda s: s[0].sum() < 1, lambda s: (s[0].double(),),
                   (torch.zeros(2),), max_trips=3)


def test_warmup_runs_the_body_once_on_a_copy():
    """In a capture's warm-up the body runs once even where the loop runs
    no trip (so the capture finds its caches filled), on a copy whose
    result is dropped."""
    calls = []

    def body(s):
        calls.append(1)
        return (s[0] + 1,)

    x = torch.zeros(3)
    jit_module._warming.on = True
    try:
        (out,) = while_loop(lambda s: torch.tensor(False), body, (x,),
                            max_trips=2)
    finally:
        jit_module._warming.on = False
    assert calls == [1] and torch.equal(out, torch.zeros(3))
    assert torch.equal(x, torch.zeros(3))


def _gated(trips):
    """while_loop as a captured graph runs it: exactly max_trips trips,
    each body gated by the condition after the trip before; `trips`
    collects the bodies taken."""

    def loop(cond_fn, body_fn, state, max_trips, on_test=None):
        taken = 0
        for _ in range(max_trips):
            if bool(cond_fn(state)):
                state = body_fn(state)
                taken += 1
        trips.append(taken)
        return state

    return loop


def _fake_detections(n, found, seed):
    g = torch.Generator().manual_seed(seed)
    valid = torch.zeros(n, D, dtype=torch.bool)
    valid[:, 0] = found
    return Detections(
        ids=torch.where(valid, torch.arange(n)[:, None], -1),
        corners=torch.rand(n, D, 4, 2, generator=g) * 50,
        centers=torch.rand(n, D, 2, generator=g) * 50,
        decision_margin=torch.where(valid, 5.0, 0.0),
        hamming=torch.zeros(n, D, dtype=torch.int32),
        areas=torch.full((n, D), 16.0), valid=valid)


def _fake_escalate(finds):
    """escalate(idx, live) that finds frame i (id 100 + i, margin 10)
    where finds[i] and the frame is live."""

    def escalate(sel_idx, sel_live):
        k = sel_idx.shape[0]
        hit = torch.zeros(k, D, dtype=torch.bool)
        hit[:, 0] = finds[sel_idx] & sel_live
        ctr = (sel_idx.to(torch.float32) * 7.0)[:, None, None].expand(
            k, D, 2)
        return Detections(
            ids=torch.where(hit, 100 + sel_idx[:, None], -1),
            corners=ctr[:, :, None, :].expand(k, D, 4, 2) + 1.0,
            centers=ctr.clone(),
            decision_margin=torch.where(hit, 10.0, 0.0),
            hamming=torch.zeros(k, D, dtype=torch.int32),
            areas=torch.full((k, D), 16.0), valid=hit)

    return escalate


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 16), stage=st.sampled_from("bc"),
       seed=st.integers(0, 2 ** 16), data=st.data())
def test_waves_bound_and_gated_trips(n, stage, seed, data):
    """The ladder's wave selection (stage B's by candidate evidence, stage
    C's by index) under a fake escalation: every loop ends within
    ceil(N / k) trips, and max_trips gated trips give the same state as
    the unbounded loop."""
    found = torch.tensor(data.draw(st.lists(st.booleans(), min_size=n,
                                            max_size=n)))
    finds = torch.tensor(data.draw(st.lists(st.booleans(), min_size=n,
                                            max_size=n)))
    k = min(robust._ESC_K, n)
    if stage == "b":
        rscores = torch.rand(n, 4, generator=torch.Generator().manual_seed(
            seed))
        select = lambda done: robust._select_b(done, rscores, k)  # noqa
    else:
        select = lambda done: robust._select_c(done, k)  # noqa: E731
    det = _fake_detections(n, found, seed)
    escalate = _fake_escalate(finds)

    robust.host_reads["wave_tests"] = 0
    want = robust._waves(det, found, select, escalate, D)
    trips = robust.host_reads["wave_tests"] - 1
    assert trips <= -(-n // k)
    assert trips == -(-int((~found).sum()) // k)
    # every frame ends found or attempted: found frames are those the
    # fake escalation could find, or found before
    assert torch.equal(want[1], found | finds)

    taken = []
    robust.while_loop = _gated(taken)
    try:
        got = robust._waves(det, found, select, escalate, D)
    finally:
        robust.while_loop = while_loop
    assert taken == [trips]
    for a, b in zip([*want[0], want[1]], [*got[0], got[1]], strict=True):
        assert torch.equal(a, b)


def _scene(tag_id, cell, top, left, h=96, w=128):
    img = np.full((h, w), 235.0, np.float32)
    t = render_tag(tag_id, cell_px=cell)
    img[top:top + t.shape[0], left:left + t.shape[1]] = t
    return img


def _blank(seed, h=96, w=128):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = 150 + 40 * np.sin(x / 23.0) * np.cos(y / 31.0)
    return np.clip(img + rng.normal(0, 6, (h, w)), 0, 255).astype(np.float32)


def _multi_wave_frames():
    """A 27 px tag that only stage B decodes, one that stage A finds and
    three tagless frames: stage B runs 2 of its 3 waves, stage C 2 of
    3."""
    return torch.from_numpy(np.stack(
        [_scene(11, 3, 21, 31), _scene(3, 6, 10, 10), _blank(0), _blank(1),
         _blank(2)]))


MULTI_WAVE_IDS = [11, 3, None, None, None]


def test_ladder_gated_trips_equal_loop(monkeypatch):
    frames = _multi_wave_frames()
    robust.host_reads["wave_tests"] = 0
    want = robust.detect_tags_robust_staged(frames, LADDER_CFG)
    assert robust.host_reads["wave_tests"] == (2 + 1) + (2 + 1)
    taken = []
    monkeypatch.setattr(robust, "while_loop", _gated(taken))
    got = robust.detect_tags_robust_staged(frames, LADDER_CFG)
    assert taken == [2, 2]
    for a, b in zip(want, got, strict=True):
        assert torch.equal(a, b)
    for i, tag in enumerate(MULTI_WAVE_IDS):
        ids = got.ids[i][got.valid[i]].tolist()
        assert ids == ([tag] if tag is not None else []), (i, ids)


def _calibrate_loop(obj_pts, img_pts, iters, n_dist=5):
    """calibrate_camera's LM as the loop it was before its step was
    compiled, from the same start (the port's own Zhang initialisation)."""
    V = img_pts.shape[0]
    Hs = [PC._homography_dlt(obj_pts[i, :, :2], img_pts[i])
          for i in range(V)]
    K0 = PC._zhang_init(Hs)
    Rs, tvecs = [], []
    Kinv = np.linalg.inv(K0)
    for H in Hs:
        h1, h2, h3 = (Kinv @ H).T
        lam = 1.0 / np.linalg.norm(h1)
        if (lam * h3)[2] < 0:
            lam = -lam
        r1, r2 = lam * h1, lam * h2
        Rm = np.column_stack([r1, r2, np.cross(r1, r2)])
        U, _, Vt = np.linalg.svd(Rm)
        Rs.append(U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt)
        tvecs.append(lam * h3)
    rvecs = PC.rodrigues_inv(torch.from_numpy(np.asarray(Rs, np.float32))
                             ).numpy()
    p = torch.from_numpy(np.concatenate([
        np.asarray([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]], np.float32),
        np.zeros(n_dist, np.float32), rvecs.reshape(-1),
        np.asarray(tvecs, np.float32).reshape(-1)]).astype(np.float32))
    obj = torch.as_tensor(obj_pts, dtype=torch.float32)
    img = torch.as_tensor(img_pts, dtype=torch.float32)

    def residuals(q):
        return PC._calib_residuals(q, obj, img, n_dist)

    eye = torch.eye(p.shape[0], dtype=torch.float32)
    lam = torch.tensor(1e-3, dtype=torch.float32)
    for _ in range(iters):
        r = residuals(p)
        J = PC._jacobian(residuals, p)
        JTJ = J.T @ J
        g = J.T @ r
        Dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(JTJ), min=1e-12))
        A = JTJ * Dinv[:, None] * Dinv[None, :]
        y = torch.linalg.solve_ex(A + lam * eye, (g * Dinv)[:, None]
                                  ).result[:, 0]
        p_new = p - y * Dinv
        better = torch.sum(residuals(p_new) ** 2) < torch.sum(r ** 2)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-10),
                          torch.clamp(lam * 5.0, max=1e3))
        p = torch.where(better, p_new, p)
    return p


def test_lm_step_replayed_equals_the_loop():
    objs, imgs = synth_views(4, noise=0.1, seed=2)
    K, dist, rms, rv, tv = PC.calibrate_camera(objs, imgs, (1280, 720),
                                               iters=10, device="cpu")
    p = _calibrate_loop(objs, imgs, 10).numpy()
    assert isinstance(PC._lm_step, Jitted)
    np.testing.assert_array_equal(K[[0, 1, 0, 1], [0, 1, 2, 2]], p[:4])
    np.testing.assert_array_equal(dist[:5], p[4:9])
    np.testing.assert_array_equal(rv.reshape(-1), p[9:21])
    np.testing.assert_array_equal(tv.reshape(-1), p[21:])


def test_calibrate_camera_vs_reference_small():
    # imported here: the card's machine has no JAX, and runs this file's
    # cuda-marked tests
    pytest.importorskip("jax")
    from repas_tpu.calib import checkerboard as JC

    objs, imgs = synth_views(6, seed=4)
    jK, jd, jrms, _, _ = JC.calibrate_camera(objs, imgs, (1280, 720),
                                             iters=60)
    tK, td, trms, _, _ = PC.calibrate_camera(objs, imgs, (1280, 720),
                                             iters=60, device="cpu")
    np.testing.assert_allclose(tK, jK, rtol=0, atol=0.01)
    np.testing.assert_allclose(td[:2], jd[:2], rtol=0, atol=1e-3)
    assert abs(trms - jrms) < 1e-5


def test_sharded_pipeline_one_step_per_shard():
    mesh = frames_mesh(devices=["cpu"] * 4)
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    run = sharded_frame_pipeline(lambda a, s: torch.sin(a) * s, mesh)
    assert len(run.steps) == 4 and len({id(s) for s in run.steps}) == 4
    assert all(isinstance(s, Jitted) for s in run.steps)
    assert torch.equal(run(shard_batch(x, mesh), 2.0), torch.sin(x) * 2.0)
    with pytest.raises(TypeError, match="not hashable"):
        run(x, [2.0])


# --- on the card -----------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_while_loop_runs_the_trips_the_data_needs(dev):
    """One graph, replayed with trip counts 0 to max_trips: each replay
    runs the bodies its condition takes, with no host read."""
    def f(x, n):
        return while_loop(lambda s: s[1] < n, lambda s: _count(*s),
                          (x, torch.zeros((), dtype=torch.int64,
                                          device=x.device)), max_trips=5)

    step = jit_module.jit(f)
    x = torch.arange(4, dtype=torch.float32, device=dev)
    for n in (3, 0, 5, 1):
        got = step(x, torch.tensor(n, device=dev))
        want = f(x, torch.tensor(n, device=dev))
        assert torch.equal(got[0], want[0]) and int(got[1]) == n
    assert len(step.graphs) == 1


@pytest.mark.cuda
def test_captured_while_node_runs_the_trips_the_data_needs(dev):
    """unroll=False: one WHILE node, replayed with trip counts 0 to past
    max_trips: each replay runs the trips its condition takes, at most
    max_trips, with no host read."""
    def f(x, n):
        return while_loop(lambda s: s[1] < n, lambda s: _count(*s),
                          (x, torch.zeros((), dtype=torch.int64,
                                          device=x.device)), max_trips=5,
                          unroll=False)

    step = jit_module.jit(f)
    x = torch.arange(4, dtype=torch.float32, device=dev)
    for n in (3, 0, 5, 1, 9):
        got = step(x, torch.tensor(n, device=dev))
        k = min(n, 5)
        want = f(x, torch.tensor(k, device=dev))
        assert torch.equal(got[0], want[0]) and int(got[1]) == k
    assert len(step.graphs) == 1
    entry = next(iter(step.graphs.values()))
    assert entry.while_nodes and entry.nodes is not None


LADDER_STEPS = ("_stage_a", "_stage_b", "_stage_c")


@pytest.mark.cuda
def test_captured_ladder_equals_eager_multi_wave(dev, monkeypatch):
    frames = _multi_wave_frames().to(dev)
    for name in LADDER_STEPS:
        getattr(robust, name).clear()
    with torch.no_grad():
        robust.detect_tags_robust_staged(frames, LADDER_CFG)    # capture
        robust.host_reads["wave_tests"] = 0
        got = robust.detect_tags_robust_staged(frames, LADDER_CFG)
        torch.cuda.synchronize()
        assert robust.host_reads["wave_tests"] == 0        # a replay
        for name in LADDER_STEPS:
            assert len(getattr(robust, name).graphs) == 1
            monkeypatch.setattr(robust, name, getattr(robust, name).fn)
        want = robust.detect_tags_robust_staged(frames, LADDER_CFG)
    for a, b in zip(want, got, strict=True):
        assert torch.equal(a, b)
    for i, tag in enumerate(MULTI_WAVE_IDS):
        ids = got.ids[i][got.valid[i]].tolist()
        assert ids == ([tag] if tag is not None else []), (i, ids)


@pytest.mark.cuda
def test_two_shards_graphs_replay_side_by_side(dev):
    """Each shard's step spins 50 ms on the device: two shards' replays
    overlap, so the sharded call takes about one spin, not two."""
    spin = int(50e-3 * torch.cuda.get_device_properties(dev).clock_rate
               * 1e3)

    def slow(x):
        torch.cuda._sleep(spin)
        return x + 1

    mesh = frames_mesh(devices=[dev, dev])
    run = sharded_frame_pipeline(slow, mesh)
    x = torch.zeros(4, device=dev)
    run(x)                                            # captures both
    assert [len(s.graphs) for s in run.steps] == [1, 1]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    one = min(timed(lambda: run.steps[0]((x[:2],), ())) for _ in range(3))
    both = min(timed(lambda: run(x)) for _ in range(3))
    assert torch.equal(run(x), x + 1)
    assert both < 1.5 * one, (both, one)
