"""The port's point-cloud filters (``cloud/filters.py``) against the JAX
package on the CPU.

Masks, representatives and compacted rows must be equal. Voxel means
within 1e-6 (m, colour units): both sum in index order on the CPU. The
outlier mask is compared exactly through ``_outlier_mask_from_sample``,
fed the sample that the reference's own ``jax.random.choice`` draws (the
port draws from a torch.Generator, whose stream cannot be JAX's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import filters as J  # noqa: E402
from repas_tpu_torch.cloud import filters as T  # noqa: E402


def _surface(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    z = 0.08 * np.sin(7 * xy[:, 0]) * np.cos(5 * xy[:, 1]) + 0.6
    pts = np.column_stack([xy, z]).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    mask = rng.random(n) > 0.1
    return pts, cols, nrm, mask


def test_radius_and_compact_match_reference():
    pts, _, _, mask = _surface(0, 3000)
    pts = pts * 1.5
    for origin in (None, np.array([0.1, -0.2, 0.3], np.float32)):
        ref = J.radius_mask(jnp.asarray(pts), jnp.asarray(mask), 0.9, origin)
        got = T.radius_mask(torch.from_numpy(pts), torch.from_numpy(mask),
                            0.9, origin)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for cap in (100, 2500, 4000):
        ref = J.compact_masked(jnp.asarray(pts), jnp.asarray(mask), cap)
        got = T.compact_masked(torch.from_numpy(pts), torch.from_numpy(mask),
                               cap)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("voxel,buckets", [(0.05, None), (0.013, None),
                                           (0.05, 64)])
def test_voxel_downsample_matches_reference(voxel, buckets):
    pts, cols, nrm, mask = _surface(1, 4000)
    ref = J.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), voxel,
                             colors=jnp.asarray(cols),
                             normals=jnp.asarray(nrm), buckets=buckets)
    got = T.voxel_downsample(*(torch.from_numpy(a) for a in (pts, mask)),
                             voxel, colors=torch.from_numpy(cols),
                             normals=torch.from_numpy(nrm), buckets=buckets)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert 10 < int(got[3].sum()) < 4000
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)


def _jax_sample(key, mask, sample):
    """The indices the reference's statistical_outlier_mask /
    estimate_normals draw."""
    n = mask.shape[0]
    probs = jnp.asarray(mask, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return np.asarray(jax.random.choice(key, n, shape=(min(sample, n),),
                                        p=probs, replace=False))


@pytest.mark.parametrize("nb,std,sample", [(20, 2.0, 1024), (8, 1.0, 2048),
                                           (20, 2.0, 5000)])
def test_statistical_outlier_mask_matches_reference(nb, std, sample):
    rng = np.random.default_rng(2)
    pts = rng.normal(scale=0.01, size=(3000, 3)).astype(np.float32)
    pts[:15] += rng.uniform(0.05, 0.2, (15, 3)).astype(np.float32)
    mask = rng.random(3000) > 0.05
    ref = np.asarray(J.statistical_outlier_mask(
        jnp.asarray(pts), jnp.asarray(mask), nb_neighbors=nb, std_ratio=std,
        sample=sample))
    idx = np.array(_jax_sample(jax.random.PRNGKey(0), mask, sample))
    got = T._outlier_mask_from_sample(
        torch.from_numpy(pts), torch.from_numpy(mask),
        torch.from_numpy(idx).long(), nb, std).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < (mask & ~got).sum() < 0.2 * mask.sum()
    # the port's own draw removes no invalid point's bit and most of the
    # 15 displaced points
    own = T.statistical_outlier_mask(torch.from_numpy(pts),
                                     torch.from_numpy(mask), nb, std,
                                     sample=sample).numpy()
    assert own.shape == got.shape and not (own & ~mask).any()
    assert (own[:15] & mask[:15]).sum() <= 3


def test_choice_draws_valid_indices():
    mask = torch.zeros(1000, dtype=torch.bool)
    mask[100:300] = True
    gen = T._generator("cpu", 5)
    picks = T._choice(mask, 4000, True, gen)
    assert bool(mask[picks].all())
    sub = T._choice(mask, 150, False, gen)
    assert bool(mask[sub].all()) and len(set(sub.tolist())) == 150
    # all invalid: uniform, no error (callers mask the results out)
    none = T._choice(torch.zeros(10, dtype=torch.bool), 5, False, gen)
    assert none.shape == (5,)
    a = T._choice(mask, 64, True, T._generator("cpu", 9))
    b = T._choice(mask, 64, True, T._generator("cpu", 9))
    assert torch.equal(a, b)
