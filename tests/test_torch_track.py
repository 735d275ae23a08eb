"""The port's register-then-track streamer against the JAX package's, on
tests/test_track.py's three scenarios (480x640, 60 mm tag 5, f = 600):
the same frames go through both trackers step by step.

Tolerances: mode, ok and tag id exact at every step; R <= 0.05 deg
(atan2 of the relative rotation in float64), t <= 0.05 mm, reprojection
error <= 2e-3 px (measured 0.012 deg, 0.0042 mm, 1e-4 px: XLA fuses the
LM's multiply-adds into FMAs, eager torch does not); the JAX test's
truth gates (3.5 mm while tracking, 3 mm on re-registration).

The reference runs with the port detector's two departures
(``tests/jax_departures.py``: converged labels, member-only support
points). The JAX package finds and decodes every tag of these frames
too, so every frame is held to that reference under the limits above.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.pose.track import TagTracker as RefTracker  # noqa: E402
from repas_tpu.pose.track import TrackerConfig as RefConfig  # noqa: E402
from repas_tpu_torch.core.config import \
    tracker_config_from_reference  # noqa: E402
from repas_tpu_torch.core.transforms import rodrigues  # noqa: E402
from repas_tpu_torch.detect.render import render_tag_in_scene  # noqa: E402
from repas_tpu_torch.pose.track import (TagTracker, TrackerConfig,  # noqa
                                        _roi_detector_config)
from jax_departures import jax_detector_departures  # noqa: E402,F401
from torch_threads import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread",
                                     "jax_detector_departures")

K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
SHAPE = (480, 640)
TAG = 0.06
R_TILT = rodrigues(torch.tensor([0.2, -0.15, 0.05])).numpy()


def _scene(tag_id, t):
    return render_tag_in_scene(tag_id, R_TILT, np.asarray(t, np.float32),
                               K, TAG, SHAPE, supersample=3)


def _angle_deg(Ra, Rb):
    Rr = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    return np.degrees(np.arctan2(np.linalg.norm(w), (np.trace(Rr) - 1) / 2))


def _both(frames, ref_cfg, **kw):
    """Step both trackers over the frames; check each step's agreement;
    return the port's results."""
    ref = RefTracker(K, tag_size=TAG, config=ref_cfg, **kw)
    port = TagTracker(K, tag_size=TAG, device="cpu",
                      config=tracker_config_from_reference(
                          dataclasses.asdict(ref_cfg)), **kw)
    out = []
    for i, f in enumerate(frames):
        a, b = ref.step(jnp.asarray(f)), port.step(f)
        assert (b.mode, b.ok, b.tag_id) == (a.mode, a.ok, a.tag_id), \
            f"step {i}: {b.mode, b.ok, b.tag_id} vs {a.mode, a.ok, a.tag_id}"
        assert _angle_deg(a.R, b.R) <= 0.05, f"step {i}"
        np.testing.assert_allclose(b.t, np.asarray(a.t), atol=5e-5)
        if np.isfinite(a.err_px):
            assert abs(b.err_px - a.err_px) <= 2e-3, f"step {i}"
        else:
            assert not np.isfinite(b.err_px)
        out.append(b)
    return out


def test_track_follows_motion_vs_reference():
    ts = [np.array([0.02 * i - 0.05, 0.01 * i, 0.5 + 0.01 * i], np.float32)
          for i in range(6)]
    res = _both([_scene(5, t) for t in ts], RefConfig(roi=256))
    assert [r.mode for r in res] == ["register"] + ["track"] * 5
    for r, t in zip(res, ts):
        assert r.ok and np.linalg.norm(r.t - t) < 3.5e-3
        assert r.R.shape == (3, 3) and r.t.shape == (3,)


def test_track_loss_and_recovery_vs_reference():
    blank = np.full(SHAPE, 180.0, np.float32)
    t2 = np.array([0.15, -0.10, 0.6], np.float32)
    frames = [_scene(5, np.array([0, 0, 0.5], np.float32)), blank, blank,
              _scene(5, t2)]
    res = _both(frames, RefConfig(roi=256, max_misses=1))
    assert [r.mode for r in res] == ["register", "lost", "lost", "register"]
    assert [r.ok for r in res] == [True, False, False, True]
    assert np.linalg.norm(res[-1].t - t2) < 3e-3


def test_track_rejects_wrong_id_vs_reference():
    t0 = np.array([0, 0, 0.5], np.float32)
    res = _both([_scene(5, t0), _scene(7, t0)],
                RefConfig(roi=256, max_misses=1), tag_id=5)
    assert res[0].ok and not res[1].ok
    assert res[1].mode == "lost" and res[1].tag_id == 5


def test_robust_registration_and_config():
    """robust_register takes the enhancement ladder's detections: the
    same tag and the truth gate."""
    t0 = np.array([0.01, -0.02, 0.5], np.float32)
    tr = TagTracker(K, tag_size=TAG, device="cpu",
                    config=TrackerConfig(robust_register=True))
    res = tr.step(_scene(5, t0))
    assert res.mode == "register" and res.ok and res.tag_id == 5
    assert np.linalg.norm(res.t - t0) < 3.5e-3
    cfg = _roi_detector_config(tr.det_cfg, 256)
    assert (cfg.quad_decimate, cfg.max_components, cfg.max_detections) == \
        (1.0, 16, 4)
    with pytest.raises(KeyError):
        tracker_config_from_reference({"roi": 256})


def test_tracker_defaults_to_the_card():
    """A tracker fed host frames runs on the card unless told otherwise;
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert TagTracker(K).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TagTracker(K)
    assert TagTracker(K, device="cpu").K.device.type == "cpu"
