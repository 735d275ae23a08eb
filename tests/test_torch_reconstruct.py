"""The port's surface reconstruction (``cloud/reconstruct.py``) against the
JAX package on the CPU, on small spheres.

``poisson_indicator_grid``: chi within 1e-5 of max |chi| (the splat's
scatter-adds and the FFTs round in another order than XLA's; measured
3.7e-7 to 7.0e-7 of max |chi| at dims 32-128), no sign flips.
``surface_nets`` on identical chi, ``mean_nn_spacing`` and
``alpha_shape``: identical. ``reconstruct_surface``: equal vertex and
triangle counts, triangles equal, vertices within 1e-3 of a cell.
``ball_pivot``: the face set equal (its grid distances differ from XLA's
by an ulp, well inside the emptiness test's 1e-4 slack).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import reconstruct as JR  # noqa: E402
from repas_tpu.io import ply as JP  # noqa: E402
from repas_tpu_torch.cloud import reconstruct as TR  # noqa: E402
from repas_tpu_torch.io import ply as TP  # noqa: E402


def _sphere(n, seed=0, r=0.1, noise=0.0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    p = v * (r + noise * rng.normal(size=(n, 1))) + [0.02, -0.01, 0.5]
    return p.astype(np.float32), v.astype(np.float32)


def _grid(pts, dim, pad_frac=0.1):
    lo, hi = pts.min(0), pts.max(0)
    span = float((hi - lo).max()) * (1 + 2 * pad_frac)
    return (lo + hi) / 2 - span / 2, span / dim


@pytest.mark.parametrize("dim,n", [(32, 3000), (48, 5000), (64, 20000),
                                   (128, 20000)])
def test_poisson_indicator_grid_matches_reference(dim, n):
    pts, nrm = _sphere(n, noise=0.002 if dim == 48 else 0.0)
    mask = np.ones(n, bool)
    mask[::17] = dim == 64                       # one masked case
    lo, cell = _grid(pts, dim)
    cj = np.asarray(JR.poisson_indicator_grid(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask),
        jnp.asarray(lo), cell, dim=dim))
    ct = TR.poisson_indicator_grid(torch.from_numpy(pts),
                                   torch.from_numpy(nrm),
                                   torch.from_numpy(mask), lo, cell,
                                   dim=dim).numpy()
    assert ct.shape == (dim,) * 3 and ct.dtype == np.float32
    scale = np.abs(cj).max()
    assert np.abs(ct - cj).max() <= 1e-5 * scale
    assert not ((ct > 0) != (cj > 0)).any()
    # surface nets on identical chi are identical
    mj, mt = JR.surface_nets(cj, lo, cell), TR.surface_nets(cj, lo, cell)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.triangles, mj.triangles)
    assert len(mt.triangles) > 1000


def test_reconstruct_surface_matches_reference():
    pts, nrm = _sphere(4000, seed=1)
    mj = JR.reconstruct_surface(JP.PointCloud(points=pts, normals=nrm),
                                dim=48)
    mt = TR.reconstruct_surface(TP.PointCloud(points=pts, normals=nrm),
                                dim=48, device="cpu")
    assert len(mt.vertices) == len(mj.vertices)
    np.testing.assert_array_equal(mt.triangles, mj.triangles)
    _, cell = _grid(pts, 48)
    assert np.abs(mt.vertices - mj.vertices).max() <= 1e-3 * cell
    # the mesh lies on the sphere, within a cell
    r = np.linalg.norm(mt.vertices - [0.02, -0.01, 0.5], axis=1)
    assert np.abs(r - 0.1).max() < cell
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (a card is present: the "
                               "default device is valid here)")
        TR.reconstruct_surface(TP.PointCloud(points=pts, normals=nrm))


@pytest.mark.parametrize("n,normals", [(800, True), (2500, False)])
def test_ball_pivot_alpha_shape_and_spacing_match_reference(n, normals):
    pts, nrm = _sphere(n, seed=2)
    kw = dict(normals=nrm) if normals else {}
    pj, pt = JP.PointCloud(points=pts, **kw), TP.PointCloud(points=pts, **kw)
    p64 = pts.astype(np.float64)
    assert TR.mean_nn_spacing(p64) == JR.mean_nn_spacing(p64)
    bj = JR.ball_pivot(pj)
    bt = TR.ball_pivot(pt, device="cpu")
    np.testing.assert_array_equal(bt.triangles, bj.triangles)
    np.testing.assert_array_equal(bt.vertices, bj.vertices)
    assert len(bt.triangles) > n
    aj, at = JR.alpha_shape(pj), TR.alpha_shape(pt)
    np.testing.assert_array_equal(at.triangles, aj.triangles)
    np.testing.assert_array_equal(at.vertices, aj.vertices)
    aj, at = JR.alpha_shape(pj, alpha=0.02), TR.alpha_shape(pt, alpha=0.02)
    np.testing.assert_array_equal(at.triangles, aj.triangles)
