"""PnP, depth correction and fusion of the port against the JAX package.

Tolerances (stated per quantity):
  * solve_pnp_best_order: the winning order exactly, and R, t and error
    as for solve_pnp_ippe_square;
  * R <= 0.01 deg, t <= 0.1 mm, reprojection error <= 1e-3 px: the LM
    Jacobian is forward mode in both packages, but rounding differs
    (XLA's CPU backend fuses multiply-adds, eager torch does not);
  * _chol_solve6: relative 1e-5 of the solution's scale;
  * depth correction: exact u,v and validity, P_depth <= 1e-6 m.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.core.transforms import rodrigues as rodrigues_j  # noqa: E402
from repas_tpu.pose import depth_correct as JD  # noqa: E402
from repas_tpu.pose import fusion as JF  # noqa: E402
from repas_tpu.pose import pnp as JP  # noqa: E402
from repas_tpu_torch.pose import depth_correct as TD  # noqa: E402
from repas_tpu_torch.pose import fusion as TF  # noqa: E402
from repas_tpu_torch.pose import pnp as TP  # noqa: E402

K = np.array([[640.0, 0, 320], [0, 640.0, 180], [0, 0, 1]], np.float32)
TAG = 0.0303


def _angle_deg(Ra, Rb):
    Rr = np.swapaxes(Ra, -1, -2) @ Rb
    c = np.clip((np.trace(Rr, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


def _corners(seed, n=12, noise=0.3):
    """Seeded square-tag poses projected to pixels, with pixel noise."""
    rng = np.random.default_rng(seed)
    rv = rng.normal(0, 0.35, (n, 3)).astype(np.float32)
    t = np.column_stack([rng.uniform(-0.05, 0.05, n),
                         rng.uniform(-0.03, 0.03, n),
                         rng.uniform(0.25, 0.8, n)]).astype(np.float32)
    obj = np.asarray(JP.square_object_points(TAG))
    R = np.asarray(jax.vmap(rodrigues_j)(jnp.asarray(rv)))
    cam = obj[None] @ np.swapaxes(R, 1, 2) + t[:, None]
    uv = cam[..., :2] / cam[..., 2:] * K[[0, 1], [0, 1]] + K[:2, 2]
    return (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pnp_ippe_square_vs_reference(seed):
    c = _corners(seed)
    Rj, tj, ej = jax.vmap(lambda x: JP.solve_pnp_ippe_square(
        x, jnp.asarray(K), None, TAG))(jnp.asarray(c))
    Rt, tt, et = TP.solve_pnp_ippe_square(torch.from_numpy(c),
                                          torch.from_numpy(K), TAG)
    assert _angle_deg(np.asarray(Rj), Rt.numpy()).max() <= 0.01
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-3)


def _square_symmetry(k):
    """The 8 rotations that map the square onto itself: turns by k*90
    degrees about its normal, then for k >= 4 a flip about its x axis."""
    c, s = np.cos(k * np.pi / 2), np.sin(k * np.pi / 2)
    turn = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return turn @ np.diag([1.0, -1.0, -1.0]) if k >= 4 else turn


@pytest.mark.parametrize("seed", [3, 4])
def test_solve_pnp_best_order_vs_reference(seed):
    """Corners handed over in shuffled orders. Every order's solve matches
    the reference's. The four cyclic orders of a square are the same pose
    turned by a multiple of 90 degrees about the tag normal, with errors
    equal up to the LM's last digits, so which of them wins is rounding
    in both packages, and so are the four mirrored orders (the square seen
    from behind). The winner must be the port's own argmin, with the
    reference's best error and translation, and the reference's rotation
    up to one of the square's 8 symmetries. R within 0.25 degrees, the
    gate the pipeline tests use: the LM's 8 steps stop where the error
    is flat to 1e-4 px and R still moves with rounding (measured up to
    0.051 degrees, angles taken in float64; 0.01 degrees holds for the
    canonical order above)."""
    c = _corners(seed, n=8, noise=0.2)
    c = np.stack([c[i][JP.SQUARE_ORDERS[i]] for i in range(8)])
    inv = np.argsort(JP.SQUARE_ORDERS, axis=1)
    Rt, tt, et, ot = TP.solve_pnp_best_order(torch.from_numpy(c),
                                             torch.from_numpy(K), TAG)
    Ra, ta, ea = TP.solve_pnp_ippe_square(torch.from_numpy(c[:, inv]),
                                          torch.from_numpy(K), TAG)
    for i in range(8):
        Rj, tj, ej = jax.vmap(lambda x: JP.solve_pnp_ippe_square(
            x, jnp.asarray(K), None, TAG))(jnp.asarray(c[i][inv]))
        assert _angle_deg(np.asarray(Rj, np.float64),
                          Ra[i].double().numpy()).max() <= 0.25
        np.testing.assert_allclose(ta[i].numpy(), np.asarray(tj), atol=1e-4)
        np.testing.assert_allclose(ea[i].numpy(), np.asarray(ej), atol=1e-3)
        score = ea[i] + torch.where(ta[i, :, 2] <= 0, 1000.0, 0.0)
        assert int(ot[i]) == int(torch.argmin(score))
        R_ref, t_ref, e_ref, _ = JP.solve_pnp_best_order(
            jnp.asarray(c[i]), jnp.asarray(K), None, TAG)
        assert abs(float(et[i]) - float(e_ref)) <= 1e-3
        np.testing.assert_allclose(tt[i].numpy(), np.asarray(t_ref),
                                   atol=1e-4)
        assert min(_angle_deg(np.asarray(R_ref, np.float64)
                              @ _square_symmetry(k), Rt[i].double().numpy())
                   for k in range(8)) <= 0.25
        assert float(tt[i, 2]) > 0
    np.testing.assert_array_equal(TP.SQUARE_ORDERS, JP.SQUARE_ORDERS)


def test_refine_pnp_gn_vs_reference():
    c = _corners(2, n=6, noise=0.5)
    obj = np.asarray(JP.square_object_points(TAG))
    rng = np.random.default_rng(3)
    rv0 = rng.normal(0, 0.3, (6, 3)).astype(np.float32)
    t0 = np.tile(np.array([0.0, 0.0, 0.5], np.float32), (6, 1))
    rj, tj, ej = jax.vmap(lambda x, r, t: JP.refine_pnp_gn(
        jnp.asarray(obj), x, r, t, jnp.asarray(K), None, iters=8))(
        jnp.asarray(c), jnp.asarray(rv0), jnp.asarray(t0))
    rt, tt, et = TP.refine_pnp_gn(torch.from_numpy(obj), torch.from_numpy(c),
                                  torch.from_numpy(rv0), torch.from_numpy(t0),
                                  torch.from_numpy(K), iters=8)
    Rj = np.asarray(jax.vmap(rodrigues_j)(rj))
    Rt = np.asarray(jax.vmap(rodrigues_j)(jnp.asarray(rt.numpy())))
    assert _angle_deg(Rj, Rt).max() <= 0.01
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-3)


def test_chol_solve6_vs_reference():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(5, 6, 6)).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(5, 6)).astype(np.float32)
    ref = np.asarray(jax.vmap(JP._chol_solve6)(jnp.asarray(A),
                                               jnp.asarray(b)))
    got = TP._chol_solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert (np.abs(got - ref) <= 1e-5 * scale).all()


def test_depth_corrected_translation_vs_reference():
    rng = np.random.default_rng(5)
    dm = rng.uniform(0.3, 1.0, (2, 60, 80)).astype(np.float32)
    dm[0, :20, :30] = 0.0                     # small window empty
    t = np.array([[[-0.2, -0.2, 0.5], [0.0, 0.0, 0.6], [1.0, 0, 0.4]],
                  [[0.0, 0.0, -0.3], [0.05, 0.02, 0.7], [0, 0, 0.5]]],
                 np.float32)
    Kd = np.array([[60.0, 0, 40], [0, 60.0, 30], [0, 0, 1]], np.float32)
    Pt, vt = TD.depth_corrected_translation(torch.from_numpy(t),
                                            torch.from_numpy(dm),
                                            torch.from_numpy(Kd))
    for b in range(2):
        Pj, vj = jax.vmap(lambda x: JD.depth_corrected_translation(
            x, jnp.asarray(dm[b]), jnp.asarray(Kd)))(jnp.asarray(t[b]))
        np.testing.assert_array_equal(vt[b].numpy(), np.asarray(vj))
        np.testing.assert_allclose(Pt[b].numpy(), np.asarray(Pj), atol=1e-6)
    assert vt.numpy().any() and (~vt.numpy()).any()


def test_fuse_tag_poses_vs_reference():
    """Two valid tags (one needs the tag-9 flip) and six dead slots with
    degenerate corners, whose NaN PnP must be masked out."""
    c = np.zeros((1, 8, 4, 2), np.float32) + 100.0
    c[0, :2] = _corners(6, n=2, noise=0.2)
    ids = np.array([[16, 9, -1, -1, -1, -1, -1, -1]], np.int32)
    valid = ids >= 0
    areas = np.array([[900.0, 700.0] + [0.0] * 6], np.float32)
    dm = np.full((1, 360, 640), 0.5, np.float32)
    ref = JF.fuse_tag_poses(jnp.asarray(c[0]), jnp.asarray(ids[0]),
                            jnp.asarray(areas[0]), jnp.asarray(valid[0]),
                            jnp.asarray(dm[0]), jnp.asarray(K), None, TAG,
                            anchor_id=16,
                            flip_z_ids=jnp.asarray([9], jnp.int32))
    got = TF.fuse_tag_poses(torch.from_numpy(c), torch.from_numpy(ids),
                            torch.from_numpy(areas), torch.from_numpy(valid),
                            torch.from_numpy(dm), torch.from_numpy(K), TAG,
                            anchor_id=16, flip_z_ids=(9,))
    assert int(got.anchor_idx[0]) == int(ref.anchor_idx) == 0
    np.testing.assert_array_equal(got.P_depth_valid[0].numpy(),
                                  np.asarray(ref.P_depth_valid))
    np.testing.assert_array_equal(got.order_idx[0].numpy(),
                                  np.asarray(ref.order_idx))
    assert _angle_deg(np.asarray(ref.R), got.R[0].numpy()).max() <= 0.01
    assert _angle_deg(np.asarray(ref.R_avg), got.R_avg[0].numpy()) <= 0.01
    for name in ("t", "anchor_t", "P_depth", "anchor_P_depth"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-4)
    np.testing.assert_allclose(got.err_px[0].numpy(), np.asarray(ref.err_px),
                               atol=1e-3)
    for x in got:
        assert torch.isfinite(x.float()).all()
