"""The port's track_stream CLI against the JAX package's, on a 240x320
replay stream (tests/test_torch_stream_scenes.py: tags 9 and 16 on a
plane at 0.45 m, the camera moving 3 mm and 2 mm a frame), through
the frame pipeline with and without the cloud
(tests/test_torch_apps_track.py runs the robust ladder and
register-then-track).

Tolerances (ROADMAP C): ids and valid slots equal; the fused
rotation within 0.25 degrees and decision margins within 0.25 gray
(XLA's FMAs move the refined corners by hundredths of a pixel: measured
0.118 degrees and 0.047 gray); the depth-corrected anchor within 1e-6 m
(measured 0: the depth median does not see the corners' ulps).
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_stream_scenes import (check_pipeline_records,  # noqa: E402
                                      stream_args, track_both)


@pytest.fixture(scope="module")
def args(tmp_path_factory):
    return stream_args(tmp_path_factory.mktemp("stream"))


@pytest.mark.parametrize("extra", [[], ["--no-pointcloud", "--frames", "2"]],
                         ids=["pointcloud", "no_pointcloud"])
def test_track_stream_matches_reference(args, tmp_path, extra):
    check_pipeline_records(*track_both(args, tmp_path, extra))
