"""Kernel B1's plain version and top-K selection against the JAX package.

Tolerance: exact (labels, roots, areas, valid, bboxes). The labels are
the fixed-iteration result, so components that have not converged in
`iters` rounds must match too; the Pallas kernel runs in interpret mode,
as the JAX package's own tests run it on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels.ccl import (_connected_components_xla,  # noqa: E402
                                   top_k_components as top_k_ref)
from repas_tpu.kernels.ccl_pallas import \
    connected_components_pallas  # noqa: E402
from repas_tpu_torch.kernels import ccl  # noqa: E402


def _masks(seed, density, shape):
    rng = np.random.default_rng(seed)
    return rng.random(shape) > density


@pytest.mark.parametrize("seed,density,iters", [
    (0, 0.55, 5), (1, 0.3, 5), (2, 0.7, 5), (3, 0.45, 2)])
def test_plain_ccl_bit_exact_vs_xla(seed, density, iters):
    masks = _masks(seed, density, (2, 64, 256))
    ref = np.stack([np.asarray(_connected_components_xla(
        jnp.asarray(m), iters=iters)) for m in masks])
    got = ccl.connected_components_plain(torch.from_numpy(masks), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # CPU tensors dispatch to the plain version
    np.testing.assert_array_equal(
        ccl.connected_components(torch.from_numpy(masks), iters).numpy(), ref)


@pytest.mark.parametrize("seed,density", [(4, 0.55), (5, 0.35)])
def test_plain_ccl_bit_exact_vs_pallas_interpret(seed, density):
    mask = _masks(seed, density, (1, 64, 128))
    ref = np.asarray(connected_components_pallas(jnp.asarray(mask[0]),
                                                 iters=5, interpret=True))
    got = ccl.connected_components_plain(torch.from_numpy(mask), 5)
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_unconverged_spiral_matches_reference():
    """A long one-pixel spiral does not converge in 1 round; the port must
    keep the reference's partial labels, not the true component min."""
    m = np.zeros((1, 33, 33), bool)
    lo, hi = 1, 31
    while lo < hi:
        m[0, lo, lo:hi + 1] = True
        m[0, lo:hi + 1, hi] = True
        m[0, hi, lo:hi + 1] = True
        m[0, lo + 2:hi + 1, lo] = True
        lo, hi = lo + 2, hi - 2
    ref = np.asarray(_connected_components_xla(jnp.asarray(m[0]), iters=1))
    got = ccl.connected_components_plain(torch.from_numpy(m), 1)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got[m[0]])) > 1      # really not converged


def _labels(seed, shape=(2, 64, 128), density=0.6, iters=5):
    masks = _masks(seed, density, shape)
    return ccl.connected_components_plain(torch.from_numpy(masks), iters)


@pytest.mark.parametrize("ring", [False, True])
def test_top_k_components_exact(ring):
    lab = _labels(6)
    kw = dict(min_area=4.0, max_area=1e9, ring_filter=ring, min_side=4.0,
              return_bbox=ring)
    ref = jax.vmap(lambda l: top_k_ref(l, 8, **kw))(jnp.asarray(lab.numpy()))
    got = ccl.top_k_components(lab, 8, **kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("ring", [False, True])
def test_top_k_components_tie_order(ring):
    """Equal-area components (and the zero-area tail) must come out in
    lax.top_k order: ties toward the lower index."""
    m = np.zeros((1, 40, 104), bool)
    for x0 in range(4, 90, 12):               # 8 identical square rings
        m[0, 8:18, x0:x0 + 10] = True
        m[0, 10:16, x0 + 2:x0 + 8] = False
    lab = ccl.connected_components_plain(torch.from_numpy(m), 5)
    kw = dict(min_area=4.0, max_area=1e9, ring_filter=ring, min_side=4.0,
              return_bbox=ring)
    ref = top_k_ref(jnp.asarray(lab[0].numpy()), 12, **kw)
    got = ccl.top_k_components(lab, 12, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    areas = got[1][0].numpy()
    assert (areas[:8] == areas[0]).all() and (areas[8:] == 0).all()


def test_top_k_stable_breaks_ties_low_index():
    vals, idx = ccl.top_k_stable(torch.tensor([1.0, 3, 3, 2, 3]), 3)
    assert idx.tolist() == [1, 2, 4] and vals.tolist() == [3, 3, 3]
