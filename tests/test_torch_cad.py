"""The port's CAD placement and refinement (``cloud/cad.py``) against the
JAX package on the CPU.

Placement: every float32 step matrix, ``T_cad_world`` and
``provenance()`` equal to the reference's (its R @ p is XLA's FMA chain,
reproduced), except the optional ZYX pre-rotation, whose sin/cos round
differently in torch: that step within one float32 ulp (6e-8). Pose txt
and ``transform_geometry``: exact.

``refine_with_icp`` is fed the reference's own normals sample (the
indices ``jax.random.choice`` draws under its default ``PRNGKey(1)``,
through ``_normals_from_sample``): fitness within 1e-6, RMSE within 1e-8
m, iterations within 2 (the converging step is decided on an f32 RMSE at
rounding level, as for ICP in ``test_torch_registration.py``), T within
1e-6 m and 1e-4 degrees. The reference's NaN RMSE (a CAD sample with no
scene point in its 27 cells makes ``0 * inf``) is reproduced: both report
NaN and run all ``max_iters``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import cad as JC  # noqa: E402
from repas_tpu.core import config as JCfg  # noqa: E402
from repas_tpu.io import ply as JP  # noqa: E402
from repas_tpu_torch.cloud import cad as TC, normals as TN  # noqa: E402
from repas_tpu_torch.core import config as TCfg  # noqa: E402
from repas_tpu_torch.io import ply as TP  # noqa: E402


def _rot(rv):
    rv = np.asarray(rv, np.float64)
    th = np.linalg.norm(rv)
    k = rv / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


@pytest.mark.parametrize("seed,mesh,pre_rot", [
    (0, False, (0.0, 0.0, 0.0)), (1, True, (0.0, 0.0, 0.0)),
    (2, False, (0.0, 0.0, 0.0)), (3, False, (90.0, 0.0, 0.0)),
    (4, True, (12.5, -33.0, 71.25))])
def test_placement_steps_equal_reference(seed, mesh, pre_rot):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(400, 3)) * 40 + rng.normal(size=3) * 100  # mm
    tri = rng.integers(0, 400, (300, 3))
    R = _rot(rng.normal(size=3)).astype(np.float32)
    anchor = (rng.normal(size=3) * 0.1 + [0, 0, 0.5]).astype(np.float32)
    geo = [(m.TriangleMesh(vertices=pts, triangles=tri) if mesh
            else m.PointCloud(points=pts)) for m in (JP, TP)]
    rj = JC.place_cad_at_anchor(geo[0], R, anchor,
                                JCfg.CadConfig(pre_rot_deg_zyx=pre_rot))
    rt = TC.place_cad_at_anchor(geo[1], torch.from_numpy(R), anchor,
                                TCfg.CadConfig(pre_rot_deg_zyx=pre_rot))
    pj, pt = rj.provenance(), rt.provenance()
    assert pt["transform_order"] == pj["transform_order"]
    for name, Tj in rj.steps:
        Tt = dict(rt.steps)[name]
        assert Tt.dtype == np.float32 == Tj.dtype
        if name == "pre_rot_zyx_about_anchor":
            np.testing.assert_allclose(Tt, Tj, rtol=0, atol=6e-8)
        else:
            np.testing.assert_array_equal(Tt, Tj, err_msg=name)
    if pre_rot == (0.0, 0.0, 0.0):
        assert pt == pj
        np.testing.assert_array_equal(rt.T_cad_world, rj.T_cad_world)
    else:
        np.testing.assert_allclose(rt.T_cad_world, rj.T_cad_world, rtol=0,
                                   atol=1e-7)
    np.testing.assert_array_equal(rt.origin_world, rj.origin_world)
    # the placed geometry, and the pose-txt path
    for name, v in vars(JC.transform_geometry(geo[0], rj.T_cad_world)
                        ).items():
        w = getattr(TC.transform_geometry(geo[1], rj.T_cad_world), name)
        np.testing.assert_array_equal(w, v, err_msg=name)
    gj, Tj = JC.apply_pose_txt(geo[0], rj.T_cad_world, 0.001)
    gt, Tt = TC.apply_pose_txt(geo[1], rj.T_cad_world, 0.001)
    np.testing.assert_array_equal(Tt, Tj)
    np.testing.assert_array_equal(
        gt.vertices if mesh else gt.points, gj.vertices if mesh else gj.points)


def _angle_deg(Ra, Rb):
    """Angle of Ra^T Rb, atan2(|sin|, cos) in float64 (arccos of the trace
    turns one ulp into a hundredth of a degree near 0)."""
    Rr = Ra.T @ Rb
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    return float(np.degrees(np.arctan2(np.linalg.norm(w),
                                       (np.trace(Rr) - 1) / 2)))


def _scene(seed=0, n=6000):
    """A bumpy 0.3 m patch at 0.5 m, the same surface sampled again as a
    CAD cloud moved by 1.2 degrees and 4 mm about its centroid, and the
    4x4 that undoes the move."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.15, 0.15, (n, 2))
    z = 0.5 + 0.03 * np.sin(20 * xy[:, 0]) * np.cos(16 * xy[:, 1])
    scene = np.column_stack([xy, z])
    xy2 = rng.uniform(-0.12, 0.12, (n, 2))
    z2 = 0.5 + 0.03 * np.sin(20 * xy2[:, 0]) * np.cos(16 * xy2[:, 1])
    cad = np.column_stack([xy2, z2])
    c = cad.mean(0)
    R, d = _rot([0.01, -0.015, 0.008]), np.array([0.003, -0.002, 0.0025])
    T_back = np.eye(4)
    T_back[:3, :3] = R.T
    T_back[:3, 3] = c - R.T @ (c + d)
    return scene, (cad - c) @ R.T + c + d, T_back


def _fed_normals(pts, mask, k=30, radius=0.02, **_):
    """The port's normals on the reference's own sample (PRNGKey(1))."""
    n = pts.shape[0]
    probs = jnp.asarray(mask.numpy(), jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = np.array(jax.random.choice(jax.random.PRNGKey(1), n,
                                     shape=(min(4096, n),), p=probs,
                                     replace=False))
    return TN._normals_from_sample(pts, mask, torch.from_numpy(idx).long(),
                                   k, radius, None)


@pytest.mark.parametrize("far_points", [0, 5], ids=["clean", "nan_rmse"])
def test_refine_with_icp_matches_reference(monkeypatch, far_points):
    scene, cad, T_back = _scene()
    if far_points:
        # CAD samples 0.4 m from the scene: no scene point in their 27
        # coarse cells, so dist is inf and the reference's RMSE is NaN
        cad = np.concatenate([cad, cad[:far_points] + [0.4, 0.0, 0.0]])
    kw = dict(cad_samples=5000, max_iters=25 if far_points else 60)
    rep_j, T_j = JC.refine_with_icp(JP.PointCloud(points=cad),
                                    JP.PointCloud(points=scene),
                                    JCfg.ICPConfig(**kw))
    monkeypatch.setattr(TC, "estimate_normals", _fed_normals)
    rep_t, T_t = TC.refine_with_icp(TP.PointCloud(points=cad),
                                    TP.PointCloud(points=scene),
                                    TCfg.ICPConfig(**kw), device="cpu")
    assert T_t.dtype == np.float64
    assert abs(rep_t["fitness"] - rep_j["fitness"]) <= 1e-6
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], rtol=0, atol=1e-6)
    assert _angle_deg(T_t[:3, :3], T_j[:3, :3]) <= 1e-4
    assert abs(rep_t["delta_translation_mm"]
               - rep_j["delta_translation_mm"]) <= 1e-3
    if far_points:
        # the reference's fault, reproduced: NaN RMSE, no early stop
        assert np.isnan(rep_j["inlier_rmse"]) and np.isnan(
            rep_t["inlier_rmse"])
        assert rep_j["iterations"] == rep_t["iterations"] == kw["max_iters"]
        assert rep_t["fitness"] < 1.0
    else:
        assert abs(rep_t["inlier_rmse"] - rep_j["inlier_rmse"]) <= 1e-8
        assert abs(rep_t["iterations"] - rep_j["iterations"]) <= 2
        assert rep_t["iterations"] < kw["max_iters"]
        assert rep_t["fitness"] > 0.95
        # the refinement undoes the 4 mm / 1.2 degree move
        assert np.abs(T_t[:3, 3] - T_back[:3, 3]).max() < 1e-3
        assert _angle_deg(T_t[:3, :3], T_back[:3, :3]) < 0.1


def test_refine_with_icp_mesh_cad_and_default_device():
    scene, cad, _ = _scene(1, 2000)
    mesh = TP.TriangleMesh(vertices=cad, triangles=np.random.default_rng(
        0).integers(0, len(cad), (1000, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (a card is present: the "
                               "default device is valid here)")
        TC.refine_with_icp(mesh, TP.PointCloud(points=scene))
    rep, T = TC.refine_with_icp(mesh, TP.PointCloud(points=scene),
                                TCfg.ICPConfig(cad_samples=1500,
                                               max_iters=5), device="cpu")
    assert rep["iterations"] <= 5 and T.shape == (4, 4)
