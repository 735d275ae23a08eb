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


# Tolerance of the SE(3) and frame helpers: exact where the reference
# multiplies by +-1 or builds matrices; within one float32 ulp of 1
# (1.19e-7 absolute, on unit-scale entries) where a 3x3 product or a
# transcendental function rounds; degrees within 1e-5 (one ulp at 100).
ULP1 = float(np.spacing(np.float32(1.0)))


def _rots(seed, n):
    return np.array(jax.vmap(J.rodrigues)(jnp.asarray(_rvecs(seed, n))))


def test_quat_multiply_vs_reference():
    rng = np.random.default_rng(10)
    a = rng.normal(size=(32, 4)).astype(np.float32)
    b = rng.normal(size=(32, 4)).astype(np.float32)
    ref = np.asarray(J.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    got = T.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_euler_vs_reference():
    rng = np.random.default_rng(11)
    z, y, x = (rng.uniform(-170, 170, 40).astype(np.float32)
               for _ in range(3))
    y[:2] = [90.0, -90.0]                        # gimbal lock
    ref = np.asarray(J.euler_zyx_to_R(z, y, x))
    got = T.euler_zyx_to_R(torch.from_numpy(z), torch.from_numpy(y),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ULP1)
    one = T.euler_zyx_to_R(30.0, -20.0, 10.0).numpy()
    np.testing.assert_allclose(one, np.asarray(J.euler_zyx_to_R(
        30.0, -20.0, 10.0)), rtol=0, atol=ULP1)
    Rs = _rots(12, 40)
    for g, r in zip(T.R_to_euler_zyx(torch.from_numpy(Rs)),
                    J.R_to_euler_zyx(jnp.asarray(Rs))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


def test_se3_builders_vs_reference():
    rng = np.random.default_rng(13)
    Rs = _rots(14, 8)
    ts = rng.normal(size=(8, 3)).astype(np.float32)
    ps = rng.normal(size=(8, 3)).astype(np.float32)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    for R, t, p in zip(Rs, ts, ps):
        Tj = np.asarray(J.make_T(jnp.asarray(R), jnp.asarray(t)))
        Tt = T.make_T(torch.from_numpy(R), torch.from_numpy(t))
        np.testing.assert_array_equal(Tt.numpy(), Tj)
        np.testing.assert_array_equal(T.T_translate(t).numpy(),
                                      np.asarray(J.T_translate(t)))
        np.testing.assert_allclose(
            T.T_rotate_about_point(torch.from_numpy(R),
                                   torch.from_numpy(p)).numpy(),
            np.asarray(J.T_rotate_about_point(jnp.asarray(R),
                                              jnp.asarray(p))),
            rtol=0, atol=4 * ULP1)
        np.testing.assert_array_equal(
            T.T_scale_about_point(1.7, torch.from_numpy(p)).numpy(),
            np.asarray(J.T_scale_about_point(1.7, jnp.asarray(p))))
        np.testing.assert_allclose(
            T.apply_T(Tt, torch.from_numpy(pts)).numpy(),
            np.asarray(J.apply_T(jnp.asarray(Tj), jnp.asarray(pts))),
            rtol=0, atol=4 * ULP1)
        np.testing.assert_allclose(T.invert_T(Tt).numpy(),
                                   np.asarray(J.invert_T(jnp.asarray(Tj))),
                                   rtol=0, atol=4 * ULP1)
    # batched: one transform per leading index
    Tb = T.make_T(torch.from_numpy(Rs), torch.from_numpy(ts))
    ref = np.stack([np.asarray(J.make_T(jnp.asarray(R), jnp.asarray(t)))
                    for R, t in zip(Rs, ts)])
    np.testing.assert_array_equal(Tb.numpy(), ref)
    got = T.apply_T(Tb, torch.from_numpy(pts)[None].expand(8, -1, -1))
    for i in range(8):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(J.apply_T(jnp.asarray(ref[i]),
                                                 jnp.asarray(pts))),
            rtol=0, atol=4 * ULP1)


def test_frames_and_validity_vs_reference():
    rng = np.random.default_rng(15)
    Rs = _rots(16, 8)
    ts = rng.normal(size=(8, 3)).astype(np.float32)
    local = rng.normal(size=(6, 3)).astype(np.float32) * 0.05
    for R, t in zip(Rs, ts):
        np.testing.assert_array_equal(
            T.cv_to_o3d_R(torch.from_numpy(R)).numpy(),
            np.asarray(J.cv_to_o3d_R(jnp.asarray(R))))
        np.testing.assert_array_equal(
            T.cv_to_o3d_t(torch.from_numpy(t)).numpy(),
            np.asarray(J.cv_to_o3d_t(jnp.asarray(t))))
        np.testing.assert_allclose(
            T.tag_local_to_camera(torch.from_numpy(local),
                                  torch.from_numpy(R),
                                  torch.from_numpy(t)).numpy(),
            np.asarray(J.tag_local_to_camera(jnp.asarray(local),
                                             jnp.asarray(R),
                                             jnp.asarray(t))),
            rtol=0, atol=4 * ULP1)
    got = T.rotation_angle_deg(torch.from_numpy(Rs[:-1]),
                               torch.from_numpy(Rs[1:])).numpy()
    ref = [float(J.rotation_angle_deg(jnp.asarray(a), jnp.asarray(b)))
           for a, b in zip(Rs[:-1], Rs[1:])]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    good = np.asarray(J.make_T(jnp.asarray(Rs[0]), jnp.asarray(ts[0])))
    skewed = good.copy()
    skewed[0, 1] += 0.05                         # not orthogonal
    flipped = good.copy()
    flipped[:3, 2] *= -1                         # det -1
    for Tm in (good, skewed, flipped):
        ok_j, ortho_j = J.is_valid_transform(jnp.asarray(Tm))
        ok_t, ortho_t = T.is_valid_transform(torch.from_numpy(Tm))
        assert bool(ok_t) == bool(ok_j)
        np.testing.assert_allclose(float(ortho_t), float(ortho_j), rtol=0,
                                   atol=4 * ULP1)
    ok_t, _ = T.is_valid_transform(torch.from_numpy(
        np.stack([good, skewed, flipped])))
    assert ok_t.tolist() == [True, False, False]
