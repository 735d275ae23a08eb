"""Error reports (``repas_tpu_torch.eval``) against the JAX package on the
CPU.

The host writers are the reference's code: reports, txt and CSV files
byte-identical. The point-to-mesh sweeps run on a closed UV sphere (a few
hundred triangles, outward winding) with points inside and outside, from
a numpy seed. Tolerances, with what was measured (jax 0.9.0, torch 2.13
CPU): distances within 1e-6 relative plus 1e-7 m (XLA contracts the dot
products into FMAs; measured 1.2e-8 m at most over 600 points and 396
triangles); the sign equal wherever
the nearest and second-nearest triangles' distances differ by more than
that tolerance (measured: every point's sign equal, no near-tie point
differed).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.eval import reports as JR  # noqa: E402
from repas_tpu_torch.eval import reports as TR  # noqa: E402
from test_torch_scenes import uv_sphere  # noqa: E402


@pytest.fixture(scope="module")
def sphere_case():
    verts, tris = uv_sphere(12, 18)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(600, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * rng.uniform(0.06, 0.14, (600, 1))).astype(np.float32)
    return pts, verts, tris


@pytest.mark.parametrize("chunk", [256, 37])
def test_point_to_mesh_distances(sphere_case, chunk):
    pts, verts, tris = sphere_case
    args = (jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(tris))
    j = np.asarray(JR.point_to_mesh_distances(*args, chunk=chunk))
    t = TR.point_to_mesh_distances(
        torch.from_numpy(pts), torch.from_numpy(verts),
        torch.from_numpy(tris), chunk=chunk).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_point_to_mesh_signed_distances(sphere_case):
    pts, verts, tris = sphere_case
    j = np.asarray(JR.point_to_mesh_signed_distances(
        jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(tris)))
    t = TR.point_to_mesh_signed_distances(
        torch.from_numpy(pts), torch.from_numpy(verts),
        torch.from_numpy(tris)).numpy()
    np.testing.assert_allclose(np.abs(t), np.abs(j), rtol=1e-6, atol=1e-7)
    # inside (|p| < r) negative, outside positive, away from the surface
    r = np.linalg.norm(pts, axis=1)
    inside = r < 0.09
    assert (t[inside] < 0).all() and (t[r > 0.11] > 0).all()
    # the sign equal wherever the nearest triangle is clear of the second
    d2 = np.stack([np.asarray(JR.point_to_mesh_distances(
        jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(tris[[k]]),
        chunk=1)) for k in range(len(tris))], 1)
    d2.sort(axis=1)
    clear = d2[:, 1] - d2[:, 0] > 1e-6 * d2[:, 0] + 1e-7
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(np.sign(t)[clear], np.sign(j)[clear])


def test_picked_points_and_correspondence_files(tmp_path):
    pp = """<?xml version="1.0" encoding="UTF-8"?>
<PickedPoints>
 <point x="1.5" y="2.5" z="3.5" name="a" active="1"/>
 <point x="-1" y="0" z="2" name="b" active="1"/>
 <point x="0.25" y="-0.5" z="1" name="c" active="1"/>
</PickedPoints>"""
    (tmp_path / "a.pp").write_text(pp)
    np.testing.assert_array_equal(TR.load_picked_points(tmp_path / "a.pp"),
                                  JR.load_picked_points(tmp_path / "a.pp"))
    rng = np.random.default_rng(1)
    ref = rng.uniform(-1, 1, (7, 3))
    meas = ref + rng.normal(0, 0.01, (7, 3))
    reps = [mod.correspondence_report(ref, meas,
                                      txt_path=tmp_path / f"{n}.txt",
                                      csv_path=tmp_path / f"{n}.csv")
            for n, mod in (("j", JR), ("t", TR))]
    assert json.dumps(reps[0], default=float) == json.dumps(reps[1],
                                                            default=float)
    for ext in ("txt", "csv"):
        assert ((tmp_path / f"t.{ext}").read_bytes()
                == (tmp_path / f"j.{ext}").read_bytes())


@pytest.mark.parametrize("signed", [False, True])
def test_surface_error_report_files(tmp_path, signed):
    d = np.random.default_rng(2).normal(0, 0.004, 3000)
    d = d if signed else np.abs(d)
    rj = JR.surface_error_report(d, txt_path=tmp_path / "j.txt")
    rt = TR.surface_error_report(d, txt_path=tmp_path / "t.txt")
    assert rj == rt and ("signed" in rt) == signed
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt"
                                                 ).read_bytes()
    np.testing.assert_array_equal(TR.error_colormap(d), JR.error_colormap(d))
