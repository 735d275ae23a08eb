"""SO(3) helpers, the unit-square homography and pinhole projection of
the port against the JAX package on the CPU.

Tolerances: 2e-6 absolute on rotation matrices, quaternions and
homographies (unit-scale values; f32 transcendental functions and the
XLA CPU backend's fused multiply-adds differ by a few ulp), 1e-4 px on
projected pixels (coordinates of a few hundred px).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.core import transforms as J  # noqa: E402
from repas_tpu.kernels import project as JP  # noqa: E402
from repas_tpu_torch.core import transforms as T  # noqa: E402
from repas_tpu_torch.kernels import project as TP  # noqa: E402


def _rvecs(seed, n=64):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, np.pi, n)
    if n >= 3:
        ang[:3] = [0.0, 1e-7, np.pi - 1e-4]   # the special branches
    return (axis * ang[:, None]).astype(np.float32)


def test_rodrigues_round_trip_vs_reference():
    rv = _rvecs(0)
    Rj = np.array(jax.vmap(J.rodrigues)(jnp.asarray(rv)))
    Rt = T.rodrigues(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=2e-6)
    inv_j = np.asarray(jax.vmap(J.rodrigues_inv)(jnp.asarray(Rj)))
    inv_t = T.rodrigues_inv(torch.from_numpy(Rj)).numpy()
    np.testing.assert_allclose(inv_t, inv_j, atol=2e-5)


def test_quaternions_and_average_vs_reference():
    Rs = np.array(jax.vmap(J.rodrigues)(jnp.asarray(_rvecs(1, 8))))
    qj = np.asarray(jax.vmap(J.R_to_quat)(jnp.asarray(Rs)))
    qt = T.R_to_quat(torch.from_numpy(Rs)).numpy()
    np.testing.assert_allclose(qt, qj, atol=2e-6)
    np.testing.assert_allclose(T.quat_to_R(torch.from_numpy(qj)).numpy(),
                               np.asarray(jax.vmap(J.quat_to_R)(
                                   jnp.asarray(qj))), atol=2e-6)
    # a cluster of nearby rotations, two masked slots (one NaN)
    base = _rvecs(2, 1)[0]
    near = base + np.random.default_rng(3).normal(0, 0.05, (6, 3))
    Rn = np.array(jax.vmap(J.rodrigues)(jnp.asarray(near, jnp.float32)))
    Rn[4] = np.nan
    w = np.array([1.0, 2.0, 0.5, 3.0, 1.0, 1.0], np.float32)
    mask = np.array([True, True, True, True, False, False])
    ref = np.asarray(J.average_rotations_quat(jnp.asarray(Rn),
                                              jnp.asarray(w),
                                              jnp.asarray(mask)))
    got = T.average_rotations_quat(torch.from_numpy(Rn)[None],
                                   torch.from_numpy(w)[None],
                                   torch.from_numpy(mask)[None])[0].numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_flip_z_and_homography_vs_reference():
    Rs = np.array(jax.vmap(J.rodrigues)(jnp.asarray(_rvecs(4, 5))))
    np.testing.assert_array_equal(
        T.flip_z_180(torch.from_numpy(Rs)).numpy(),
        np.asarray(jax.vmap(J.flip_z_180)(jnp.asarray(Rs))))
    rng = np.random.default_rng(5)
    quads = (np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
             * 0.2 + rng.normal(0, 0.02, (16, 4, 2)).astype(np.float32))
    Hj = np.asarray(jax.vmap(J.homography_from_unit_square)(
        jnp.asarray(quads)))
    Ht = T.homography_from_unit_square(torch.from_numpy(quads)).numpy()
    np.testing.assert_allclose(Ht, Hj, atol=2e-6)


def test_project_points_vs_reference():
    rng = np.random.default_rng(6)
    K = np.array([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]], np.float32)
    pts = rng.uniform(-0.1, 0.1, (7, 3)).astype(np.float32)
    rv = _rvecs(7, 4) * 0.3
    tv = np.array([[0.01, -0.02, 0.5]] * 4, np.float32)
    ref = np.asarray(jax.vmap(lambda r, t: JP.project_points(
        jnp.asarray(pts), r, t, jnp.asarray(K)))(jnp.asarray(rv),
                                                 jnp.asarray(tv)))
    got = TP.project_points(torch.from_numpy(pts), torch.from_numpy(rv),
                            torch.from_numpy(tv), torch.from_numpy(K))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
