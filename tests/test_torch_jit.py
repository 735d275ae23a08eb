"""The port's counterpart of jax.jit (repas_tpu_torch/core/jit.py) and the
steps compiled with it: the pipeline's process_frames_jit and the
tracker's _track_roi with its origin and tag id as device tensors.

On the CPU a jitted function runs directly, so the CPU tests check the
cache key, the refusal of non-static Python arguments, that the
compiled pipeline hands back the function's own result (96x128 frames
with the dry run's detector), the tensor-origin ROI crop against a
slice at host ints (an interior origin and each frame edge), that
swapping the codebook drops every captured graph and that a capture
pins the constants it reads. No JAX compile.

The ``cuda``-marked tests skip without a card. On one:
``python -m pytest -m cuda tests/test_torch_jit.py``. Capture plus
replay is bit-equal to the eager step (the graph replays the same
kernels on the same inputs), a replay launches B1-B3 once each inside
its graph and nothing through the wrappers, two queued replays return
distinct tensors, a swapped codebook reaches the compiled step, two
trackers stepping on two streams in two threads get what each gets
alone, and a host read inside a captured function raises.
"""
import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.core import jit as jit_module  # noqa: E402
from repas_tpu_torch.core.config import DetectorConfig, PipelineConfig  # noqa
from repas_tpu_torch.core.consts import const  # noqa: E402
from repas_tpu_torch.core.jit import jit  # noqa: E402
from repas_tpu_torch.core.transforms import rodrigues  # noqa: E402
from repas_tpu_torch.detect import tag_families  # noqa: E402
from repas_tpu_torch.detect.detector import detect_tags  # noqa: E402
from repas_tpu_torch.detect.render import (example_frame,  # noqa: E402
                                           render_tag_in_scene)
from repas_tpu_torch.graft_entry import DRYRUN_DETECTOR  # noqa: E402
from repas_tpu_torch.kernels import _build  # noqa: E402
from repas_tpu_torch.pipeline import (process_frames,  # noqa: E402
                                      process_frames_jit)
from repas_tpu_torch.pose.pnp import (refine_pnp_gn,  # noqa: E402
                                      square_object_points)
from repas_tpu_torch.pose.track import (TagTracker,  # noqa: E402
                                        _roi_detector_config, _track_roi)

CFG = PipelineConfig(detector=DRYRUN_DETECTOR)
DIST = np.array([-0.05, 0.01, 0.001, -0.0005, 0.002], np.float32)
STATIC = ("config", "with_pointcloud")

# _track_roi's scene: a 40 mm tag 9 tilted, 0.55 m away, in a 160x192
# frame; every 128 px ROI below holds it
ROI_K = np.array([[600.0, 0, 96], [0, 600.0, 80], [0, 0, 1]], np.float32)
ROI_T = np.array([0.0, 0.0, 0.55], np.float32)
ROI_RV = (0.2, -0.15, 0.05)
ROI, ROI_TAG, ROI_ID = 128, 0.04, 9
ROI_CFG = _roi_detector_config(DetectorConfig(), ROI)
ORIGINS = {"interior": (32, 16), "left": (0, 16), "right": (64, 16),
           "top": (32, 0), "bottom": (32, 32)}


def _frames(batch, dev="cpu"):
    rgb, depth, K = example_frame(96, 128)
    rng = np.random.default_rng(0)
    rgbs = np.clip(np.stack([rgb] * batch).astype(np.int16)
                   + rng.integers(-8, 8, (batch, *rgb.shape)), 0,
                   255).astype(np.uint8)
    return (torch.from_numpy(rgbs).to(dev),
            torch.from_numpy(np.stack([depth] * batch)).to(dev),
            torch.from_numpy(K).to(dev))


def _assert_equal_trees(a, b):
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0))), \
            (a, b)
        return
    assert type(a) is type(b)
    for x, y in zip(a, b, strict=True):
        _assert_equal_trees(x, y)


def test_key_reuses_an_entry_for_equal_shapes_and_statics():
    r, d, K = _frames(2)
    key = process_frames_jit.key(r, d, K, CFG)
    assert process_frames_jit.key(r.clone(), d.clone(), K + 1, CFG) == key
    # a static left at its default equals the same value passed
    assert process_frames_jit.key(r, d, K, CFG, True) == key
    assert process_frames_jit.key(r, d, K, config=CFG,
                                  with_pointcloud=True) == key
    assert hash(key) == hash(process_frames_jit.key(r, d, K, CFG))


@pytest.mark.parametrize("change", ["shape", "dtype", "static", "dist",
                                    "pointcloud", "inference_mode"])
def test_key_changes_with_shape_dtype_static_and_none(change):
    r, d, K = _frames(2)
    key = process_frames_jit.key(r, d, K, CFG)
    if change == "shape":
        other = process_frames_jit.key(r[:1], d[:1], K, CFG)
    elif change == "dtype":
        other = process_frames_jit.key(r, d, K.double(), CFG)
    elif change == "static":
        other = process_frames_jit.key(r, d, K, PipelineConfig())
    elif change == "dist":
        other = process_frames_jit.key(r, d, K, CFG,
                                       dist=torch.from_numpy(DIST))
        assert process_frames_jit.key(r, d, K, CFG, dist=None) != other
    elif change == "pointcloud":
        other = process_frames_jit.key(r, d, K, CFG, with_pointcloud=False)
    else:
        with torch.inference_mode():
            other = process_frames_jit.key(r, d, K, CFG)
    assert other != key


def test_key_follows_nested_tuples():
    f = jit(lambda pair, scale: pair[0] * scale + pair[1],
            static_argnames=("scale",))
    a, b = torch.ones(3), torch.zeros(3)
    assert f.key((a, b), 2.0) == f.key((b, a), 2.0)
    assert f.key((a, b), 2.0) != f.key((a, b[:2]), 2.0)
    assert f.key((a, b), 2.0) != f.key((a, b), 3.0)
    assert f.key((a, b), 2.0) != f.key([a, b], 2.0)
    assert torch.equal(f((a, b), 2.0), a * 2.0 + b)


@pytest.mark.parametrize("bad", ["python_float", "numpy_K", "nested_int"])
def test_non_static_python_argument_raises(bad):
    r, d, K = _frames(2)
    if bad == "python_float":
        f = jit(lambda x, s: x * s)
        with pytest.raises(TypeError, match="argument s "):
            f(torch.ones(2), 2.0)
    elif bad == "numpy_K":
        with pytest.raises(TypeError, match="argument K "):
            process_frames_jit(r, d, K.numpy(), CFG)
    else:
        f = jit(lambda pair: pair[0])
        with pytest.raises(TypeError, match=r"argument pair\[1\] "):
            f((torch.ones(2), 3))
    with pytest.raises(TypeError, match="static argument config is not "
                       "hashable"):
        process_frames_jit(r, d, K, config=[CFG])


def test_static_argnames_must_be_parameters():
    with pytest.raises(ValueError, match="static_argnames"):
        jit(process_frames, static_argnames=("cfg",))


@pytest.mark.parametrize("with_dist", [False, True])
def test_compiled_process_frames_equals_eager_on_the_cpu(with_dist):
    """On the CPU the compiled step is the function itself: one call with
    the caller's own tensors, its result object handed back."""
    r, d, K = _frames(2)
    dist = torch.from_numpy(DIST) if with_dist else None
    calls = []

    @functools.wraps(process_frames)
    def spy(*args, **kwargs):
        out = process_frames(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    with torch.no_grad():
        got = jit(spy, static_argnames=STATIC)(r, d, K, CFG, dist=dist)
    ((args, kwargs, out),) = calls
    assert got is out
    assert all(a is b for a, b in zip(args, (r, d, K, CFG), strict=True))
    assert kwargs["dist"] is dist
    assert int(got.detections.valid.sum()) == 2


def test_set_active_codebook_clears_every_compiled_step(monkeypatch):
    """The counterpart of jax.clear_caches(): a graph captured with the
    old family table must not replay under the new one."""
    monkeypatch.setattr(tag_families, "_ACTIVE_CODES",
                        tag_families._ACTIVE_CODES)
    steps = (process_frames_jit, TagTracker._track, TagTracker._detect,
             jit(lambda x: x))
    for step in steps:
        step.graphs["captured"] = None
    tag_families.set_active_codebook(tag_families.TAG36H11_CODES[5:])
    assert not any(step.graphs for step in steps)


def test_a_capture_pins_the_constants_it_reads():
    """A captured graph keeps the cached constants it read alive, so an
    eviction from the constant cache cannot free a replay's memory."""
    x = object()
    assert jit_module.pin(x) is x      # outside a capture nothing is kept
    jit_module._pinning.pins = pins = []
    try:
        c = const((1.5, 2.5), torch.float32, "cpu")
    finally:
        jit_module._pinning.pins = None
    assert len(pins) == 1 and pins[0] is c


def _host_int_track_roi(img, u0, v0, tag_id, rvec_prev, tvec_prev, K, dist,
                        tag_size, det_cfg, roi, min_margin, gn_iters):
    """_track_roi's reference: the ROI a slice at host ints, the rest
    the same."""
    det = detect_tags(img[None, v0:v0 + roi, u0:u0 + roi], det_cfg)
    match = det.valid[0] & (det.ids[0] == tag_id) & \
        (det.decision_margin[0] >= min_margin)
    i = torch.argmax(torch.where(match, det.decision_margin[0], -1.0))
    found = match.any()
    c = det.corners[0].index_select(0, i.reshape(1))[0]
    corners = torch.stack([c[:, 0] + u0, c[:, 1] + v0], dim=-1)
    obj = square_object_points(tag_size, img.device)
    rvec, tvec, err = refine_pnp_gn(obj, corners, rvec_prev, tvec_prev, K,
                                    dist, iters=gn_iters)
    rvec = torch.where(found, rvec, rvec_prev)
    tvec = torch.where(found, tvec, tvec_prev)
    err = torch.where(found, err, float("inf"))
    return found, rvec, tvec, err, corners


def _roi_inputs(dev="cpu"):
    R = rodrigues(torch.tensor(ROI_RV)).numpy()
    gray = render_tag_in_scene(ROI_ID, R, ROI_T, ROI_K, ROI_TAG, (160, 192),
                               supersample=3)
    img = np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3,
                    axis=-1)
    rvec = torch.tensor(ROI_RV, dtype=torch.float32) + 0.01
    tvec = torch.from_numpy(ROI_T + np.float32(0.002))
    return (torch.from_numpy(img).to(dev), rvec.to(dev), tvec.to(dev),
            torch.from_numpy(ROI_K).to(dev), torch.zeros(8, device=dev))


@pytest.mark.parametrize("where", sorted(ORIGINS))
def test_track_roi_tensor_origin_equals_host_int_crop(where):
    img, rvec, tvec, K, dist = _roi_inputs()
    u0, v0 = ORIGINS[where]
    statics = (ROI_TAG, ROI_CFG, ROI, 10.0, 10)
    want = _host_int_track_roi(img, u0, v0, ROI_ID, rvec, tvec, K, dist,
                               *statics)
    origin = torch.tensor([u0, v0, ROI_ID], dtype=torch.int32)
    step = jit(_track_roi, static_argnames=(
        "tag_size", "det_cfg", "roi", "min_margin", "gn_iters"))
    got = step(img, origin[0], origin[1], origin[2], rvec, tvec, K, dist,
               *statics)
    assert bool(want[0]), f"the {where} ROI lost the tag"
    _assert_equal_trees(got, want)


def test_calibration_jacobian_under_inference_mode():
    """calib/checkerboard.py's forward-mode Jacobian makes its duals
    outside inference mode: the same bits under torch.inference_mode()."""
    from repas_tpu_torch.calib.checkerboard import (_calib_residuals,
                                                    _jacobian)
    rng = np.random.default_rng(0)
    obj = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.1, 0.1, (2, 6, 2)), np.zeros((2, 6, 1))],
        axis=-1).astype(np.float32))
    img = torch.from_numpy(rng.uniform(0, 640, (2, 6, 2)).astype(np.float32))
    p = torch.from_numpy(np.concatenate([
        [600.0, 610.0, 320.0, 240.0], rng.normal(0, 0.01, 5),
        rng.normal(0, 0.2, 6), [0.01, -0.02, 0.5, 0.03, 0.01, 0.6]]
    ).astype(np.float32))

    def res(q):
        return _calib_residuals(q, obj, img, 5)

    want = _jacobian(res, p)
    with torch.inference_mode():
        got = _jacobian(res, p.clone())
    assert want.shape == (24, 21)
    assert torch.equal(got, want)


# --- on the card -----------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_dist", [False, True])
def test_capture_replay_equals_eager_process_frames(dev, with_dist):
    r, d, K = _frames(2, dev)
    dist = torch.from_numpy(DIST).to(dev) if with_dist else None
    step = jit(process_frames, static_argnames=STATIC)
    with torch.no_grad():
        want = process_frames(r, d, K, CFG, dist=dist)
        first = step(r, d, K, CFG, dist=dist)        # capture + replay
        again = step(r, d, K, CFG, dist=dist)        # replay
    torch.cuda.synchronize()
    assert len(step.graphs) == 1
    _assert_equal_trees(first, want)
    _assert_equal_trees(again, want)


@pytest.mark.cuda
def test_capture_replay_equals_eager_track_roi(dev):
    img, rvec, tvec, K, dist = _roi_inputs(dev)
    statics = (ROI_TAG, ROI_CFG, ROI, 10.0, 10)
    step = jit(_track_roi, static_argnames=(
        "tag_size", "det_cfg", "roi", "min_margin", "gn_iters"))
    for where in sorted(ORIGINS):
        u0, v0 = ORIGINS[where]
        origin = torch.tensor([u0, v0, ROI_ID], dtype=torch.int32).to(dev)
        with torch.no_grad():
            want = _track_roi(img, origin[0], origin[1], origin[2], rvec,
                              tvec, K, dist, *statics)
            got = step(img, origin[0], origin[1], origin[2], rvec, tvec, K,
                       dist, *statics)
        torch.cuda.synchronize()
        assert bool(want[0]), where
        _assert_equal_trees(got, want)
    assert len(step.graphs) == 1        # one graph for every origin


@pytest.mark.cuda
def test_replay_launches_only_inside_its_graph(dev):
    """The wrappers count the warm-up's and the capture's launches; a
    replay adds no count, and the profiler's trace shows B1-B3 once each
    per replay."""
    from torch.profiler import ProfilerActivity, profile

    r, d, K = _frames(2, dev)
    step = jit(process_frames, static_argnames=STATIC)
    names = {"ccl": "ccl_band", "patch_extract": "window_copy",
             "pointcloud": "pointcloud"}
    with torch.no_grad():
        before = dict(_build.launches)
        step(r, d, K, CFG)
        torch.cuda.synchronize()
        assert {k: _build.launches[k] - before[k] for k in names} == {
            k: jit_module.WARMUP + 1 for k in names}
        before = dict(_build.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)        # the trace drops events before its
            for _ in range(3):      # window opened: start well inside it
                step(r, d, K, CFG)
            torch.cuda.synchronize()
            time.sleep(0.02)
    assert _build.launches == before
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert {k: sum(v in n for n in kernels) for k, v in names.items()} == {
        k: 3 for k in names}


@pytest.mark.cuda
def test_queued_replays_return_distinct_tensors(dev):
    r, d, K = _frames(2, dev)
    r2 = torch.flip(r, dims=(2,)).contiguous()     # the tag mirrored
    step = jit(process_frames, static_argnames=STATIC)
    with torch.no_grad():
        step(r, d, K, CFG)
        torch.cuda.set_sync_debug_mode("error")    # a replay never waits
        try:
            a = step(r, d, K, CFG)
            b = step(r2, d, K, CFG)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want_a = process_frames(r, d, K, CFG)
        want_b = process_frames(r2, d, K, CFG)
    torch.cuda.synchronize()
    for x, y in zip(a.detections, b.detections):
        assert x.data_ptr() != y.data_ptr()
    _assert_equal_trees(a, want_a)
    _assert_equal_trees(b, want_b)


@pytest.mark.cuda
def test_swapped_codebook_reaches_the_compiled_step(dev, monkeypatch):
    """A codebook swapped after a capture: the compiled step decodes with
    the new table, as the eager step does (tag 9 becomes id 4 in the
    family without its first five codes)."""
    monkeypatch.setattr(tag_families, "_ACTIVE_CODES",
                        tag_families._ACTIVE_CODES)
    r, d, K = _frames(2, dev)
    with torch.no_grad():
        before = process_frames_jit(r, d, K, CFG)
        tag_families.set_active_codebook(tag_families.TAG36H11_CODES[5:])
        try:
            assert not process_frames_jit.graphs
            want = process_frames(r, d, K, CFG)
            got = process_frames_jit(r, d, K, CFG)
            again = process_frames_jit(r, d, K, CFG)
        finally:
            tag_families.set_active_codebook(tag_families.TAG36H11_CODES)
    torch.cuda.synchronize()
    assert before.detections.ids[:, 0].tolist() == [9, 9]
    assert want.detections.ids[:, 0].tolist() == [4, 4]
    _assert_equal_trees(got, want)
    _assert_equal_trees(again, want)


def _camera_frames(t0, step, n=6):
    """n 480x640 RGB frames of tag 5 (60 mm, f = 600) moving by `step`."""
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
    R = rodrigues(torch.tensor([0.2, -0.15, 0.05])).numpy()
    frames = []
    for i in range(n):
        t = np.asarray(t0, np.float32) + i * np.asarray(step, np.float32)
        gray = render_tag_in_scene(5, R, t, K, 0.06, (480, 640),
                                   supersample=3)
        frames.append(np.repeat(np.clip(gray, 0, 255).astype(np.uint8)
                                [..., None], 3, axis=-1))
    return K, frames


@pytest.mark.cuda
def test_two_trackers_on_two_streams(dev):
    """The tracker's compiled steps are shared by every tracker, with one
    set of static buffers a graph: two cameras, each tracked in its own
    thread on its own CUDA stream, get what each gets alone."""
    cams = [_camera_frames((0.0, 0.0, 0.5), (0.002, 0.001, 0.0)),
            _camera_frames((-0.05, 0.03, 0.6), (0.0, -0.002, 0.001))]

    def run(K, frames):
        tr = TagTracker(K, tag_size=0.06, device=dev)
        return [tr.step(f) for f in frames]

    alone = [run(K, frames) for K, frames in cams]    # captures the steps
    assert [r.mode for r in alone[0]] == ["register"] + ["track"] * 5
    together = [None, None]

    def worker(i):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            together[i] = run(*cams[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(alone, together, strict=True):
        assert [(r.mode, r.ok, r.tag_id) for r in a] == \
            [(r.mode, r.ok, r.tag_id) for r in b]
        for x, y in zip(a, b):
            assert np.array_equal(x.R, y.R) and np.array_equal(x.t, y.t)


@pytest.mark.cuda
def test_host_read_inside_a_capture_raises(dev):
    """Last in the file: the failed capture is left behind on its own
    stream."""
    def reads(x):
        return x * float(x.sum())

    step = jit(reads)
    with pytest.raises(RuntimeError, match=r"jit\(.*reads\): CUDA graph "
                       "capture failed"):
        step(torch.ones(4, device=dev))
    assert not step.graphs
