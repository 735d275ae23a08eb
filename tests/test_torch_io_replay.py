"""The port's replay backend (io/replay.py), pose-sequence dataset
(io/dataset.py) and profiling hooks (utils/profiling.py) against the JAX
package's, on files written into a tmp_path. Host code copied from the
reference, so every record is held exactly equal: the pairs the globs
and the stamp regex find, each frame's arrays (bit for bit), stamps,
scales and intrinsics, the stream profiles, select_profile's three
rungs, the dataset's fields and write_pose's bytes.
"""
import json
import logging

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repas_tpu.io import dataset as JD, replay as JR  # noqa: E402
from repas_tpu_torch.io import dataset as TD, replay as TR  # noqa: E402
from repas_tpu_torch.io.image import write_depth_png, write_image  # noqa: E402


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The layouts of ReplayBackend's docstring, in a root and a
    subdirectory, with the files the index must skip."""
    root = tmp_path_factory.mktemp("captures")
    rng = np.random.default_rng(0)

    def rgb(h=24, w=32):
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def depth(h=24, w=32):
        return rng.uniform(0.3, 2.0, (h, w)).astype(np.float32)

    # realsense testing_scripts: rgb_<ts>.png + depth_raw_<ts>.png
    for ts in ("20250101_120000", "20250101_120001"):
        write_image(root / f"rgb_{ts}.png", rgb())
        write_depth_png(root / f"depth_raw_{ts}.png", depth())
    # a colormapped preview the index must skip, a colour-only frame
    write_image(root / "depth_raw_20250101_120000_vis.png", rgb())
    write_image(root / "rgb_20250101_120002.png", rgb())
    # canopy captures (depth at half resolution)
    sub = root / "canopy"
    sub.mkdir()
    write_image(sub / "canopy_capture_20250102T101010_HD.png", rgb(48, 64))
    write_depth_png(sub / "depth_snapshot_20250102T101010_HD.png",
                    depth(24, 32))
    # better_three_capture: color + aligned u16 png + metres npy
    cap = root / "capture_2025-01-03T090909"
    cap.mkdir()
    write_image(cap / "color_2025-01-03T090909.png", rgb())
    write_depth_png(cap / "aligned_depth_2025-01-03T090909.png", depth())
    np.save(cap / "aligned_depth_m_2025-01-03T090909.npy", depth())
    write_image(cap / "depth_cm_2025-01-03T090909.png", rgb())
    (root / "K.json").write_text(json.dumps(
        {"fx": 40.0, "fy": 41.0, "cx": 16.0, "cy": 12.0, "width": 32,
         "height": 24}))
    return root


def _same_frame(a, b):
    for k in ("color", "depth_raw", "depth_m"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert (a.timestamp, a.depth_scale, a.aligned) == \
        (b.timestamp, b.depth_scale, b.aligned)
    dm_a, dm_b = a.depth_meters(), b.depth_meters()
    assert (dm_a is None) == (dm_b is None)
    if dm_a is not None:
        assert dm_a.dtype == dm_b.dtype == np.float32
        assert np.array_equal(dm_a.view(np.uint32), dm_b.view(np.uint32))
    ia, ib = a.color_intrinsics, b.color_intrinsics
    assert (ia is None) == (ib is None)
    if ia is not None:
        assert ia.to_dict() == ib.to_dict()


@pytest.mark.parametrize("kw", [{}, {"recursive": False},
                                {"intrinsics_json": "K.json",
                                 "depth_scale": 0.0005}],
                         ids=["recursive", "flat", "intrinsics"])
def test_replay_backend_matches_reference(captures, kw):
    kw = {k: (captures / v if k == "intrinsics_json" else v)
          for k, v in kw.items()}
    j, t = JR.ReplayBackend(captures, **kw), TR.ReplayBackend(captures, **kw)
    assert len(j) == len(t) == (3 if kw.get("recursive") is False else 5)
    assert [tuple(map(str, p)) for p in j._pairs] == \
        [tuple(map(str, p)) for p in t._pairs]
    assert [tuple(vars(p).values()) for p in j.profiles()] == \
        [tuple(vars(p).values()) for p in t.profiles()]
    fj, ft = j.read_all(), t.read_all()
    assert len(fj) == len(ft) == len(j)
    for a, b in zip(fj, ft):
        _same_frame(a, b)


def test_replay_backend_loop_and_empty(tmp_path, captures):
    j = JR.ReplayBackend(captures, loop=True, recursive=False)
    t = TR.ReplayBackend(captures, loop=True, recursive=False)
    gj, gt = j.frames(), t.frames()
    for _ in range(7):                   # past one pass: it loops
        _same_frame(next(gj), next(gt))
    assert len(TR.ReplayBackend(tmp_path / "none")) == 0
    assert TR.ReplayBackend(tmp_path / "none").profiles() == []
    assert TR.CameraBackend().device_status() == \
        JR.CameraBackend().device_status()
    assert TR.CameraBackend().rescue() is JR.CameraBackend().rescue()


def test_select_profile_three_rungs_match_reference():
    specs = [("color", 1280, 720, "yuyv", 15), ("color", 1280, 720, "rgb", 30),
             ("color", 640, 480, "rgb", 30), ("depth", 640, 480, "y16", 30)]
    pj = [JR.StreamProfile(*s) for s in specs]
    pt = [TR.StreamProfile(*s) for s in specs]
    queries = [("color", 1280, 720, "rgb", 30),      # exact
               ("color", 1280, 720, "bgr", 60),      # same size, any format
               ("color", 1920, 1080, None, None),    # default
               ("depth", 640, 480, "y16", None),
               ("color", 640, 480, None, 15)]
    for q in queries:
        a, b = JR.select_profile(pj, *q), TR.select_profile(pt, *q)
        assert tuple(vars(a).values()) == tuple(vars(b).values()), q
    with pytest.raises(LookupError):
        TR.select_profile(pt, "infrared", 640, 480)


def test_pose_sequence_dataset_matches_reference(tmp_path, rng):
    """tests/test_dataset.py's contract, each field against the JAX
    reader, and write_pose's bytes."""
    root = tmp_path / "seq"
    for sub in ("rgb", "depth", "mask"):
        (root / sub).mkdir(parents=True)
    K = np.array([[600.0, 0, 64], [0, 600.0, 48], [0, 0, 1.0]])
    np.savetxt(root / "cam_K.txt", K)
    for i in range(3):
        write_image(root / "rgb" / f"{i:06d}.png",
                    rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
        d = np.full((96, 128), 0.5 + 0.1 * i, np.float32)
        if i == 2:
            np.save(root / "depth" / f"{i:06d}.npy", d)
        else:
            write_depth_png(root / "depth" / f"{i:06d}.png", d)
        m = np.zeros((96, 128), dtype=np.uint8)
        m[20:60, 30:90] = 255
        write_image(root / "mask" / f"{i:06d}.png", m)
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.9]

    dj, dt = JD.PoseSequenceDataset(root), TD.PoseSequenceDataset(root)
    assert len(dj) == len(dt) == 3
    np.testing.assert_array_equal(dt.K, dj.K)
    pt = dt.write_pose("000001", T)
    b_port = pt.read_bytes()
    pj = dj.write_pose("000001", T)
    assert pt == pj and pj.read_bytes() == b_port
    for a, b in zip(dj, dt):
        assert (a.index, a.stem) == (b.index, b.stem)
        for k in ("rgb", "depth_m", "mask", "K", "pose"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert dt[1].mask.sum() == 40 * 60
    np.testing.assert_array_equal(dt[1].pose, T)
    assert dt[0].pose is None


def test_profiling_hooks(tmp_path, caplog):
    import torch

    from repas_tpu_torch.utils import FpsCounter, stage_timer
    from repas_tpu_torch.utils.profiling import device_trace

    log = logging.getLogger("PERF")
    log.addHandler(caplog.handler)
    try:
        with stage_timer("stage", sync=lambda: {"x": (torch.ones(3),)}):
            pass
        with stage_timer("plain"):
            pass
    finally:
        log.removeHandler(caplog.handler)
    assert [r.getMessage().split(":")[0] for r in caplog.records] == \
        ["stage", "plain"]
    fps = FpsCounter(interval=0.0)
    assert fps.tick(5) > 0 and fps.fps > 0
    assert FpsCounter(interval=60.0).tick() is None
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
