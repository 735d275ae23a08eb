"""The port's detect_tags, estimate_pose and validate_pose CLIs against the
JAX package's, on 240x320 captures of tests/test_torch_stream_scenes.py
(tags 9 and 16 on a plane at 0.45 m; for `validate_pose translation` two
captures 10 mm apart; for --layout a capture with both tags upright).

Tolerances (ROADMAP C): ids, hamming, valid slots and the chosen tag
equal; corners within 0.1 px and decision margins within 0.25 gray
(XLA's FMAs in the edge refiner: most corners agree within 0.001 px,
but where the bf16 patch ties a gradient plateau one moves by part of a
search step, measured up to 0.07 px on 19 tags of this scene; ROADMAP
C's 0.05 px was measured on other scenes); rotations within 0.25
degrees; best-order PnP translations within 0.05 mm (measured 2e-5 m)
and the fusion's IPPE translations within 1 mm (measured 0.26 mm: a
0.07 px corner on a 40 px tag moves its range by 0.2 %); the
depth-corrected anchor and the depth medians within 1e-6 m. The
bundle's SQPnP translation within 0.5 mm (ROADMAP C's SQPnP tolerance;
measured 0.053 mm). The best-order PnP's rotation is held to the truth
up to the square's symmetry: its eight orders tie to the LM's last
digits (ROADMAP C), and here the two packages pick different orders
(`manual`: 90.14 and 179.18 degrees from the hand-measured pose), so
each rotation delta must lie within 1.5 degrees of a multiple of 90.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repas_tpu_torch.io.pose_txt import save_transform_txt  # noqa: E402
from test_torch_stream_scenes import (TAG, TAGS, Z0, angle_deg,  # noqa: E402
                                      render_view, run_both, write_frame,
                                      write_intrinsics)

from jax_departures import jax_detector_departures  # noqa: E402,F401
from torch_threads import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread",
                                     "jax_detector_departures")

STAMP = "20250101_000000"
MOVE = np.array([0.01, 0.0, 0.0])        # the second capture's camera shift


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("pose_scene")
    for i, c in enumerate((np.zeros(3), MOVE)):
        rgb, depth = render_view(c=c, seed=11 + i)
        write_frame(d / f"cap{i}", STAMP, rgb, depth)
    rgb, depth = render_view(seed=13, flipped=())
    write_frame(d / "upright", STAMP, rgb, depth)
    write_intrinsics(d / "K.json")
    (d / "layout.json").write_text(json.dumps(
        {str(k): [x, y, 0.0] for k, (x, y) in TAGS.items()}))
    T = np.eye(4)
    T[:3, 3] = [TAGS[16][0], TAGS[16][1], Z0]
    save_transform_txt(d / "manual.txt", T)
    return d


def _src(scene, depth=True, cap="cap0"):
    a = ["--color", str(scene / cap / f"rgb_{STAMP}.png")]
    if depth:
        a += ["--depth", str(scene / cap / f"depth_raw_{STAMP}.png")]
    return a + ["--intrinsics", str(scene / "K.json"), "--tag-size",
                str(TAG)]


def test_detect_tags_cli_matches_reference(scene, tmp_path):
    ref, port, rj, rt = run_both(
        "detect_tags", [str(scene / "cap0" / f"rgb_{STAMP}.png"),
                        "--json", "{out}/det.json"], tmp_path, ["det.json"])
    a = json.loads((ref / "det.json").read_text())[0]["detections"]
    b = json.loads((port / "det.json").read_text())[0]["detections"]
    assert [d["id"] for d in a] == [d["id"] for d in b]
    assert sorted(d["id"] for d in b) == [9, 16]
    for x, y in zip(a, b):
        assert x["hamming"] == y["hamming"] == 0
        np.testing.assert_allclose(y["corners"], x["corners"], atol=0.1)
        np.testing.assert_allclose(y["center"], x["center"], atol=0.1)
        assert abs(x["decision_margin"] - y["decision_margin"]) <= 0.25
    assert [d["id"] for d in rt[0]["detections"]] == [d["id"] for d in b]


def test_estimate_pose_cli_matches_reference(scene, tmp_path):
    ref, port, a, b = run_both(
        "estimate_pose", _src(scene) + ["--json", "{out}/pose.json"],
        tmp_path, ["pose.json"])
    assert json.loads((port / "pose.json").read_text())["anchor_id"] == 16
    assert [t["id"] for t in a["tags"]] == [t["id"] for t in b["tags"]]
    assert a["anchor_id"] == b["anchor_id"] == 16
    for x, y in zip(a["tags"], b["tags"]):
        assert angle_deg(x["R"], y["R"]) <= 0.25
        assert x["P_depth_valid"] == y["P_depth_valid"]
        np.testing.assert_allclose(y["t"], x["t"], atol=1e-3)
        np.testing.assert_allclose(y["P_depth"], x["P_depth"], atol=1e-6)
    assert angle_deg(a["R_avg"], b["R_avg"]) <= 0.25
    np.testing.assert_allclose(b["anchor_P_depth"], a["anchor_P_depth"],
                               atol=1e-6)
    np.testing.assert_allclose(b["anchor_P_depth"],
                               [TAGS[16][0], TAGS[16][1], Z0], atol=0.005)


def test_estimate_pose_layout_bundle_matches_reference(scene, tmp_path):
    _, _, a, b = run_both(
        "estimate_pose", _src(scene, cap="upright")
        + ["--layout", str(scene / "layout.json")],
        tmp_path)
    assert a["mode"] == b["mode"] == "bundle"
    assert sorted(a["tags_used"]) == sorted(b["tags_used"]) == [9, 16]
    assert angle_deg(a["R_world_to_camera"], b["R_world_to_camera"]) <= 0.25
    np.testing.assert_allclose(b["t_world_to_camera"],
                               a["t_world_to_camera"], atol=5e-4)
    np.testing.assert_allclose(b["t_world_to_camera"], [0, 0, Z0],
                               atol=0.005)
    assert abs(a["reproj_err_px"] - b["reproj_err_px"]) <= 0.05


def test_validate_pose_translation_matches_reference(scene, tmp_path):
    _, _, a, b = run_both(
        "validate_pose", ["translation", "--captures", str(scene / "cap0"),
                          str(scene / "cap1"), "--intrinsics",
                          str(scene / "K.json"), "--tag-size", str(TAG),
                          "--expected-delta", *map(str, -MOVE)], tmp_path)
    for x, y in zip(a["poses"], b["poses"]):
        np.testing.assert_allclose(y["t"], x["t"], atol=5e-5)
    (da,), (db,) = a["deltas"], b["deltas"]
    np.testing.assert_allclose(db["delta_t"], da["delta_t"], atol=1e-4)
    assert db["error_mm"] < 2.0          # the known 10 mm step


@pytest.mark.parametrize("cmd", ["depth", "threeway", "manual"])
def test_validate_pose_single_frame_matches_reference(scene, tmp_path, cmd):
    args = _src(scene, depth=cmd != "manual")
    if cmd == "manual":
        args += ["--pose", str(scene / "manual.txt")]
    _, _, a, b = run_both("validate_pose", [cmd] + args, tmp_path)
    assert a["id"] == b["id"]
    if cmd == "depth":
        assert abs(a["pointcloud_z"] - b["pointcloud_z"]) <= 1e-6
        assert abs(a["pnp_z"] - b["pnp_z"]) <= 5e-5
        assert abs(a["scale_factor"] - b["scale_factor"]) <= 2e-4
        np.testing.assert_allclose(b["t_corrected"], a["t_corrected"],
                                   atol=5e-5)
        assert abs(b["pointcloud_z"] - Z0) < 0.002
    elif cmd == "threeway":
        for k in ("t_pnp_mm", "t_detector_mm", "t_depth_mm"):
            np.testing.assert_allclose(b[k], a[k], atol=0.05)
        assert b["pnp_vs_depth_mm"] < 5.0
    else:
        for r in (a, b):
            d = r["rotation_delta_deg"] % 90.0
            assert min(d, 90.0 - d) <= 1.5
        np.testing.assert_allclose(b["translation_delta_mm"],
                                   a["translation_delta_mm"], atol=0.05)
