"""The port's grid-hash k-NN (``cloud/knn.py``) against the JAX package on
the CPU.

Integers (grid slots, neighbour indices) must be equal; distances within
1e-6 m. The reference sums a squared distance as XLA's fused
fma(z, z, fma(y, y, x*x)), the port in plain float32 order, so distances
differ by an ulp and a neighbour could only swap with one at the same
distance to an ulp: the clouds here are random, and the one test of
exact ties uses a lattice whose squared distances are exact either way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import knn as J  # noqa: E402
from repas_tpu_torch.cloud import knn as T  # noqa: E402

DIMS = (16, 16, 16)


def _cloud(seed, n=3000, invalid=0.1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pts[:20] *= 1.6                      # beyond the grid: clamped cells
    mask = rng.random(n) > invalid
    return pts, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_grid_hash_build_matches_reference():
    pts, mask = _cloud(0)
    origin = np.array([-0.55, -0.5, -0.52], np.float32)
    gj = J.grid_hash_build(jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(origin), 0.07, DIMS, 4)
    gt = T.grid_hash_build(*_t(pts, mask, origin), 0.07, DIMS, 4)
    assert gt.cell_of.dtype == torch.int32
    np.testing.assert_array_equal(gt.cell_of.numpy(), np.asarray(gj.cell_of))
    assert (np.asarray(gj.cell_of) >= 0).sum() > 1000


@pytest.mark.parametrize("chunk", [700, 16384])
def test_grid_hash_query_matches_reference(chunk):
    pts, mask = _cloud(1)
    q, qmask = _cloud(2, n=2500)
    q = q * 0.9
    origin = np.array([-0.55, -0.5, -0.52], np.float32)
    gj = J.grid_hash_build(jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(origin), 0.07, DIMS, 8)
    ij, dj = J.grid_hash_query(gj, jnp.asarray(pts), jnp.asarray(q),
                               jnp.asarray(qmask), DIMS, chunk=chunk)
    tp, tm, tq, tqm, to = _t(pts, mask, q, qmask, origin)
    gt = T.grid_hash_build(tp, tm, to, 0.07, DIMS, 8)
    it, dt = T.grid_hash_query(gt, tp, tq, tqm, DIMS, chunk=chunk)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    assert (it.numpy() >= 0).mean() > 0.8
    # the port's chunking changes nothing
    i2, d2 = T.grid_hash_query(gt, tp, tq, tqm, DIMS, chunk=333)
    assert torch.equal(i2, it) and torch.equal(d2, dt)


def test_grid2_and_nearest_neighbors_match_reference():
    pts, mask = _cloud(3)
    q, qmask = _cloud(4, n=3000)
    q = pts + np.random.default_rng(5).normal(0, 0.01, pts.shape).astype(
        np.float32)
    g2j = J.grid2_build(jnp.asarray(pts), jnp.asarray(mask), 0.08,
                        coarse_dims=DIMS, fine_dims=(24, 24, 24))
    ij, dj = J.grid2_query(g2j, jnp.asarray(pts), jnp.asarray(q),
                           jnp.asarray(qmask), coarse_dims=DIMS,
                           fine_dims=(24, 24, 24))
    tp, tm, tq, tqm = _t(pts, mask, q, qmask)
    g2t = T.grid2_build(tp, tm, 0.08, coarse_dims=DIMS,
                        fine_dims=(24, 24, 24))
    for a, b in ((g2t.coarse, g2j.coarse), (g2t.fine, g2j.fine)):
        np.testing.assert_array_equal(a.cell_of.numpy(),
                                      np.asarray(b.cell_of))
    it, dt = T.grid2_query(g2t, tp, tq, tqm, coarse_dims=DIMS,
                           fine_dims=(24, 24, 24))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    ij, dj = J.nearest_neighbors(jnp.asarray(pts), jnp.asarray(mask),
                                 jnp.asarray(q), jnp.asarray(qmask), 0.08,
                                 dims=DIMS)
    it, dt = T.nearest_neighbors(tp, tm, tq, tqm, 0.08, dims=DIMS)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)


def _same_sets(it, ij, dt, dj):
    it, ij = it.numpy(), np.asarray(ij)
    assert it.shape == ij.shape
    for a, b in zip(it, ij):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    return it


@pytest.mark.parametrize("k,chunk", [(8, 8192), (12, 500), (200, 1000)])
def test_grid_hash_query_knn_matches_reference(k, chunk):
    pts, mask = _cloud(6, n=2000)
    origin = np.array([-0.82, -0.82, -0.82], np.float32)
    gj = J.grid_hash_build(jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(origin), 0.11, DIMS, 6)
    ij, dj = J.grid_hash_query_knn(gj, jnp.asarray(pts), jnp.asarray(pts),
                                   jnp.asarray(mask), DIMS, k, chunk=chunk)
    tp, tm, to = _t(pts, mask, origin)
    gt = T.grid_hash_build(tp, tm, to, 0.11, DIMS, 6)
    it, dt = T.grid_hash_query_knn(gt, tp, tp, tm, DIMS, k, chunk=chunk)
    got = _same_sets(it, ij, dt, dj)
    if k > 27 * 6:                           # padded past the candidates
        assert (got[:, 27 * 6:] == -1).all()


def test_knn_neighbors_matches_reference():
    pts, mask = _cloud(7, n=3000, invalid=0.05)
    # under jit, as its callers run it (XLA folds the constant divisor)
    knn_j = jax.jit(J.knn_neighbors, static_argnames=("k", "dims", "slots"))
    ij, dj = knn_j(jnp.asarray(pts), jnp.asarray(mask), 0.09, k=10,
                   dims=DIMS, slots=16)
    tp, tm = _t(pts, mask)
    it, dt = T.knn_neighbors(tp, tm, 0.09, 10, dims=DIMS, slots=16)
    got = _same_sets(it, ij, dt, dj)
    valid = mask & (got[:, 0] >= 0)
    assert (got[valid, 0] == np.flatnonzero(valid)).all()     # self first


def test_knn_ties_go_to_the_lower_column():
    # a lattice of spacing 1/8: squared distances are exact in float32
    # (with or without FMA), so every query has exact ties
    g = np.arange(6, dtype=np.float32) * 0.125
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    mask = np.ones(len(pts), bool)
    origin = np.full(3, -0.0625, np.float32)
    gj = J.grid_hash_build(jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(origin), 0.125, (8, 8, 8), 2)
    ij, dj = J.grid_hash_query_knn(gj, jnp.asarray(pts), jnp.asarray(pts),
                                   jnp.asarray(mask), (8, 8, 8), 9)
    tp, tm, to = _t(pts, mask, origin)
    gt = T.grid_hash_build(tp, tm, to, 0.125, (8, 8, 8), 2)
    it, dt = T.grid_hash_query_knn(gt, tp, tp, tm, (8, 8, 8), 9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert len(np.unique(dt.numpy()[:, 1])) == 1     # six-way ties
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
