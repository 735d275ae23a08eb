"""The port's normal estimation (``cloud/normals.py``) against the JAX
package on the CPU.

``ok`` must be equal; normals within 1e-4 per component, compared after
the camera flip (an eigenvector's sign is free, the flip fixes it; the
neighbourhood sums and the 3x3 eigh round differently). The sampled
``estimate_normals`` is compared through ``_normals_from_sample``, fed
the sample the reference's own ``jax.random.choice`` draws.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import normals as J  # noqa: E402
from repas_tpu_torch.cloud import normals as T  # noqa: E402

CAM = np.array([0.0, 0.0, 2.0], np.float32)


def _surface(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    z = (0.08 * np.sin(7 * xy[:, 0]) * np.cos(5 * xy[:, 1])
         + 0.05 * xy[:, 0] ** 2)
    pts = np.column_stack([xy, z]).astype(np.float32)
    return pts, rng.random(n) > 0.05


@pytest.mark.parametrize("chunk", [65536, 700])
def test_estimate_normals_grid_matches_reference(chunk):
    pts, mask = _surface(0, 3000)
    nj, okj = J.estimate_normals_grid(jnp.asarray(pts), jnp.asarray(mask),
                                      k=16, radius=0.06, dims=(24, 24, 24),
                                      slots=24, chunk=chunk,
                                      camera=jnp.asarray(CAM))
    nt, okt = T.estimate_normals_grid(torch.from_numpy(pts),
                                      torch.from_numpy(mask), k=16,
                                      radius=0.06, dims=(24, 24, 24),
                                      slots=24, chunk=chunk, camera=CAM)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.numpy().mean() > 0.9
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-4)
    assert (nt.numpy()[okt.numpy(), 2] > 0).all()       # toward the camera


@pytest.mark.parametrize("k,radius,sample", [(30, 0.08, 1024),
                                             (16, 0.05, 4096)])
def test_estimate_normals_matches_reference(k, radius, sample):
    pts, mask = _surface(1, 2500)
    nj, okj = J.estimate_normals(jnp.asarray(pts), jnp.asarray(mask), k=k,
                                 radius=radius, sample=sample,
                                 camera=jnp.asarray(CAM))
    n = len(pts)
    probs = jnp.asarray(mask, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = np.array(jax.random.choice(jax.random.PRNGKey(1), n,
                                     shape=(min(sample, n),), p=probs,
                                     replace=False))
    nt, okt = T._normals_from_sample(torch.from_numpy(pts),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(idx).long(), k, radius,
                                     CAM)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.numpy().mean() > 0.5
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-4)
    own, own_ok = T.estimate_normals(torch.from_numpy(pts),
                                     torch.from_numpy(mask), k=k,
                                     radius=radius, sample=sample, camera=CAM)
    assert own.shape == nt.shape and (own[own_ok, 2] > 0).all()
