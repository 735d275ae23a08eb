"""The port's fuse_views --voxel against the JAX package's, on the two
views of tests/test_torch_apps_fuse.py.

The fused full-resolution clouds agree within 0.012 mm (that file), and
those 0.01 mm move a boundary point into the next voxel now and then, so
the voxel counts agree within 0.05 % (measured 24,517 and 24,519), 98 %
of the port's voxel means lie within 0.1 mm of the reference's nearest
(measured 98.7 %) and every one within a voxel side (measured 3.0 mm),
colours within one 8-bit level where the means agree.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from scipy.spatial import cKDTree  # noqa: E402

from repas_tpu_torch.io.ply import read_ply  # noqa: E402
from test_torch_apps_fuse import write_views  # noqa: E402
from test_torch_stream_scenes import run_both  # noqa: E402


def test_fuse_views_voxel_matches_reference(tmp_path):
    _, args = write_views(tmp_path / "views")
    ref, port, _, _ = run_both(
        "fuse_views", args + ["--out", "{out}/fused.ply", "--voxel", "0.005"],
        tmp_path, ["fused.ply"])
    pa, pb = read_ply(ref / "fused.ply"), read_ply(port / "fused.ply")
    assert abs(len(pb.points) - len(pa.points)) <= 5e-4 * len(pa.points)
    assert len(pb.points) > 1000
    dist, idx = cKDTree(pa.points).query(pb.points)
    assert (dist <= 1e-4).mean() >= 0.98 and dist.max() <= 0.005
    near = dist <= 1e-4
    assert np.abs(pb.colors[near] - pa.colors[idx[near]]).max() \
        <= 1 / 255 + 1e-9
