"""The port's track_stream CLI against the JAX package's, on a 240x320
replay stream (tests/test_torch_stream_scenes.py: tags 9 and 16 on a
plane at 0.45 m, the camera moving 3 mm and 2 mm a frame), through
the robust ladder (--robust) and register-then-track (--temporal).

Tolerances (ROADMAP C): ids and valid slots equal; the fused
rotation within 0.25 degrees and decision margins within 0.25 gray
(XLA's FMAs move the refined corners by hundredths of a pixel: measured
0.118 degrees and 0.047 gray); the depth-corrected anchor within 1e-6 m
(measured 0: the depth median does not see the corners' ulps); the
tracker's modes, ok flags and tag ids equal, its LM translation within
0.05 mm and rotation within 0.25 degrees (measured 0.013 mm and 0.029
degrees), its reprojection error within 0.01 px.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_stream_scenes import (angle_deg,  # noqa: E402
                                      check_pipeline_records, stream_args,
                                      track_both)

from jax_departures import jax_detector_departures  # noqa: E402,F401
from torch_threads import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread",
                                     "jax_detector_departures")


@pytest.fixture(scope="module")
def args(tmp_path_factory):
    return stream_args(tmp_path_factory.mktemp("stream"))


def test_track_stream_robust_matches_reference(args, tmp_path):
    check_pipeline_records(*track_both(args, tmp_path,
                                       ["--robust", "--frames", "1"]))


def test_track_stream_temporal_matches_reference(args, tmp_path):
    ref, port = track_both(args, tmp_path, ["--temporal"])
    assert [r["mode"] for r in port] == ["register", "track", "track"]
    for a, b in zip(ref, port):
        assert (a["mode"], a["ok"], a["tag_id"]) == \
            (b["mode"], b["ok"], b["tag_id"])
        assert angle_deg(a["R"], b["R"]) <= 0.25
        np.testing.assert_allclose(b["t"], a["t"], rtol=0, atol=5e-5)
        assert abs(a["err_px"] - b["err_px"]) <= 0.01
    # the camera moved by 2 x (3, 2, 0) mm: the tag by the opposite
    dt = np.subtract(port[2]["t"], port[0]["t"])
    np.testing.assert_allclose(dt, [-0.006, -0.004, 0.0], atol=1e-3)
