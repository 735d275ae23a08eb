"""The port's fuse_views CLI against the JAX package's on two 240x320 views
of tests/test_torch_stream_scenes.py's scene (tags 9 and 16 on a plane
at 0.45 m, two bumps below tag 16): one camera facing the plane, one
turned 25 degrees about y and moved (-0.19, 0, 0.042) m so that it
still faces the tags; then --cad with a patch of the scene's surface
around the bumps in tag 16's frame (mm)
(tests/test_torch_apps_fuse_voxel.py runs --voxel).

Tolerances, measured on this scene: each view's anchor id and point
count equal; its camera-to-world T within 0.01 degrees and 0.1 mm
(measured 0.0017 degrees and 0.011 mm: the robust ladder's corners,
ROADMAP C); the fused points within 0.1 mm (measured 0.012 mm) and
their colours equal (the full-frame clouds are exact, only the pose
moves them); the CAD's ICP-refined T_cad_world, the port's
normals fed the reference's own sample (tests/test_torch_apps.py), within
0.1 mm and 0.05 degrees (measured 0.022 mm and 0.018 degrees: it fits
a scene the poses moved by 0.012 mm), its fitness within 1e-3. ICP's iteration
counts are not compared (the reference's NaN-RMSE fault, reproduced,
and a converging step decided at rounding level; ROADMAP C). The plane pose of a camera 6 degrees off the plane's
normal is ambiguous for 40 px tags (IPPE's two branches), which
flipped one view 18 degrees between the packages; the turned view here
is 25 degrees off.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repas_tpu_torch.cloud import cad as TC  # noqa: E402
from repas_tpu_torch.io.ply import PointCloud, read_ply, write_ply  # noqa: E402
from test_torch_apps import _fed_normals  # noqa: E402
from test_torch_stream_scenes import (TAG, TAGS, Z0, angle_deg,  # noqa: E402
                                      render_view, rot_y, run_both,
                                      surface_z, write_frame,
                                      write_intrinsics)

VIEW_B = (rot_y(25.0), np.array([-0.19, 0.0, 0.042]))


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    return write_views(tmp_path_factory.mktemp("views"))


def write_views(d):
    """The two views and the CAD under d; fuse_views' arguments."""
    for name, (R, c), seed in (("a", (np.eye(3), np.zeros(3)), 1),
                               ("b", VIEW_B, 2)):
        rgb, depth = render_view(R, c, seed=seed)
        write_frame(d / name, "20250101_000000", rgb, depth)
    x, y = np.meshgrid(np.linspace(0.0, 0.18, 60), np.linspace(0.03, 0.16, 45))
    surf = np.stack([x, y, surface_z(x, y)], -1).reshape(-1, 3)
    origin = np.array([TAGS[16][0], TAGS[16][1], Z0])
    write_ply(d / "cad.ply",
              PointCloud(points=((surf - origin) * 1000).astype(np.float32)))
    return d, ["--views", str(d / "a"), str(d / "b"), "--intrinsics",
               str(write_intrinsics(d / "K.json")), "--tag-size", str(TAG)]


def test_fuse_views_cad_matches_reference(views, tmp_path, monkeypatch):
    # the port's ICP normals fed the reference's own sample
    monkeypatch.setattr(TC, "estimate_normals", _fed_normals)
    d, args = views
    ref, port, _, _ = run_both(
        "fuse_views", args + ["--out", "{out}/fused.ply", "--cad",
                              str(d / "cad.ply")], tmp_path,
        ["fused.ply", "fused.meta.json", "cad_fused.ply",
         "cad_fused.meta.json"])
    mj = json.loads((ref / "fused.meta.json").read_text())
    mt = json.loads((port / "fused.meta.json").read_text())
    assert len(mj["views"]) == len(mt["views"]) == 2
    for a, b in zip(mj["views"], mt["views"]):
        assert (a["n_points"], a["anchor_id"]) == (b["n_points"],
                                                   b["anchor_id"])
        assert b["anchor_id"] == 16 and b["n_points"] == 240 * 320
        Ta, Tb = np.array(a["T_world_from_camera"]), np.array(
            b["T_world_from_camera"])
        assert angle_deg(Ta[:3, :3], Tb[:3, :3]) <= 0.01
        np.testing.assert_allclose(Tb[:3, 3], Ta[:3, 3], atol=1e-4)
    pa, pb = read_ply(ref / "fused.ply"), read_ply(port / "fused.ply")
    np.testing.assert_allclose(pb.points, pa.points, rtol=0, atol=1e-4)
    assert np.array_equal(pb.colors, pa.colors)
    # both views put the tag plane where the other does: tag 16's
    # neighbourhood at the world origin's z
    near = np.linalg.norm(pb.points[:, :2], axis=1) < 0.02
    assert abs(float(np.median(pb.points[near, 2]))) < 0.002

    ca = json.loads((ref / "cad_fused.meta.json").read_text())
    cb = json.loads((port / "cad_fused.meta.json").read_text())
    assert ca["kind"] == cb["kind"] == "cad_transform"
    Ta, Tb = np.array(ca["T_cad_world"]), np.array(cb["T_cad_world"])
    np.testing.assert_allclose(Tb[:3, 3], Ta[:3, 3], atol=1e-4)
    assert angle_deg(Ta[:3, :3] / 1e-3, Tb[:3, :3] / 1e-3) <= 0.05
    assert abs(ca["icp"]["fitness"] - cb["icp"]["fitness"]) <= 1e-3
    assert cb["icp"]["fitness"] > 0.9
