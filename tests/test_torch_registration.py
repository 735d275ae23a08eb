"""The port's point-to-plane ICP and two-stage registration
(``cloud/registration.py``) against the JAX package on the CPU.

Tolerances: ICP's T within 1e-5 m and 1e-3 degrees, fitness within 1e-4,
RMSE within 1e-6 m. The iteration count within 2: the loop stops when
the RMSE moves less than rel_tol = 1e-6 relative, which for a float32
RMSE is the size of its rounding (the 6x6 normal equations sum over all
points in another order here), so the converging step can come one or
two steps apart. ``register_clouds`` draws its RANSAC samples from a
torch.Generator, not JAX's stream, so its result is held to the recipe's
truth gates (tests/test_registration.py) and to 1 mm and 0.1 degrees of
the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import registration as J  # noqa: E402
from repas_tpu.core.transforms import make_T, rodrigues  # noqa: E402
from repas_tpu_torch.cloud import registration as T  # noqa: E402


def _angle_deg(Ra, Rb):
    Rr = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    return float(np.degrees(np.arctan2(np.linalg.norm(w),
                                       (np.trace(Rr) - 1) / 2)))


def _icp_scene(rng):
    """tests/test_cloud.py::test_icp_recovers_small_transform's scene."""
    base = np.column_stack([
        rng.uniform(-0.5, 0.5, 2000), rng.uniform(-0.5, 0.5, 2000),
        np.zeros(2000)]).astype(np.float32)
    base[:, 2] = 0.05 * np.sin(4 * base[:, 0]) + 0.05 * np.cos(3 * base[:, 1])
    rv = np.array([0.01, -0.015, 0.02], dtype=np.float32)
    t = np.array([0.01, 0.005, -0.008], dtype=np.float32)
    R = np.asarray(rodrigues(jnp.asarray(rv)))
    src = ((base - t) @ R).astype(np.float32)
    nrm = np.column_stack([-0.2 * np.cos(4 * base[:, 0]),
                           0.15 * np.sin(3 * base[:, 1]), np.ones(2000)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    return src, base, nrm, R, t


def _assert_close_T(Tt, Tj, t_tol, r_tol):
    Tt, Tj = np.asarray(Tt), np.asarray(Tj)
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= t_tol
    assert _angle_deg(Tt[:3, :3], Tj[:3, :3]) <= r_tol


@pytest.mark.parametrize("max_iters,T_init", [(50, None), (8, "offset")])
def test_icp_point_to_plane_matches_reference(rng, max_iters, T_init):
    src, base, nrm, R, t = _icp_scene(rng)
    mask = np.ones(2000, bool)
    if T_init is not None:
        T_init = np.asarray(make_T(rodrigues(jnp.asarray(
            np.array([0.0, 0.01, -0.01], np.float32))),
            jnp.asarray(np.array([0.004, 0.0, 0.002], np.float32))))
    rj = J.icp_point_to_plane(jnp.asarray(src), jnp.asarray(mask),
                              jnp.asarray(base), jnp.asarray(mask),
                              jnp.asarray(nrm), max_corr_dist=0.05,
                              max_iters=max_iters, dims=(32, 32, 32),
                              T_init=T_init)
    rt = T.icp_point_to_plane(*(torch.from_numpy(a) for a in
                                (src, mask, base, mask, nrm)),
                              max_corr_dist=0.05, max_iters=max_iters,
                              dims=(32, 32, 32), T_init=T_init)
    _assert_close_T(rt.T.numpy(), rj.T, 1e-5, 1e-3)
    assert abs(float(rt.fitness) - float(rj.fitness)) <= 1e-4
    assert abs(float(rt.inlier_rmse) - float(rj.inlier_rmse)) <= 1e-6
    assert abs(rt.iterations - int(rj.iterations)) <= 2
    assert rt.iterations <= max_iters
    # the recovered pose (tests/test_cloud.py's gates)
    T_true = np.asarray(make_T(jnp.asarray(R), jnp.asarray(t)))
    np.testing.assert_allclose(rt.T.numpy()[:3, 3], T_true[:3, 3], atol=2e-3)
    assert float(rt.fitness) > 0.9


def test_evaluate_registration_matches_reference(rng):
    src, base, _, R, t = _icp_scene(rng)
    full = np.ones(2000, bool)
    part = full.copy()
    part[::9] = False
    T_true = np.asarray(make_T(jnp.asarray(R), jnp.asarray(t)))
    for Tm in (np.eye(4, dtype=np.float32), T_true):
        for mask in (full, part):
            fj, ej = J.evaluate_registration(
                jnp.asarray(src), jnp.asarray(mask), jnp.asarray(base),
                jnp.asarray(full), jnp.asarray(Tm), max_corr_dist=0.02,
                dims=(32, 32, 32))
            ft, et = T.evaluate_registration(
                *(torch.from_numpy(a) for a in (src, mask, base, full)), Tm,
                max_corr_dist=0.02, dims=(32, 32, 32))
            assert abs(float(ft) - float(fj)) <= 1e-4
            # a masked source point has dist inf and weight 0: 0 * inf
            # makes the reference's RMSE NaN, and the port's
            np.testing.assert_allclose(float(et), float(ej), rtol=0,
                                       atol=1e-6)
            assert np.isnan(float(et)) == (mask is part)
    assert float(ft) > 0.8


def _surface_pair(rng, n):
    """tests/test_registration.py's known-pose pair."""
    pts = np.column_stack([
        rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
        np.zeros(n)]).astype(np.float32)
    pts[:, 2] = (0.08 * np.sin(7 * pts[:, 0]) * np.cos(5 * pts[:, 1])
                 + 0.05 * pts[:, 0] ** 2
                 + 0.04 * np.sin(3 * pts[:, 1]))
    rv = np.array([0.04, -0.06, 0.30], dtype=np.float32)
    t = np.array([0.06, -0.04, 0.05], dtype=np.float32)
    R = np.asarray(rodrigues(jnp.asarray(rv)))
    return ((pts - t) @ R).astype(np.float32), pts, R, t


def test_register_clouds_recipe_matches_reference(rng):
    n = 30_000
    src, tgt, R, t = _surface_pair(rng, n)
    mask = np.ones(n, bool)
    rj, fit_gj, voxel_j = J.register_clouds(jnp.asarray(src),
                                            jnp.asarray(mask),
                                            jnp.asarray(tgt),
                                            jnp.asarray(mask),
                                            icp_iters=30, seed=0)
    rt, fit_g, voxel = T.register_clouds(src, mask, tgt, mask, icp_iters=30,
                                         seed=0, device="cpu")
    assert rt.T.device.type == "cpu"
    assert abs(voxel - voxel_j) <= 1e-7 * voxel_j
    # test_register_clouds_recipe's truth gates
    T_true = np.asarray(make_T(jnp.asarray(R), jnp.asarray(t)))
    Tt = rt.T.numpy()
    assert fit_g > 0.15, fit_g
    assert float(rt.fitness) > 0.5, float(rt.fitness)
    assert _angle_deg(Tt[:3, :3], T_true[:3, :3]) < 2.0
    np.testing.assert_allclose(Tt[:3, 3], T_true[:3, 3], atol=0.01)
    # and the reference's own result
    _assert_close_T(Tt, rj.T, 1e-3, 0.1)


def test_numpy_input_needs_a_device_or_a_card():
    src = np.zeros((10, 3), np.float32)
    mask = np.ones(10, bool)
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy input runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.register_clouds(src, mask, src, mask)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.global_register_fpfh(src, mask, src, mask, 0.01)
