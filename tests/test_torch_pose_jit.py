"""The last seven ``jax.jit`` sites of the JAX package as compiled steps
beside their plain functions (``solve_pnp_ippe_square_jit``,
``refine_pnp_gn_jit``, ``solve_pnp_sqpnp_jit``,
``solve_pnp_best_order_jit``, ``fuse_tag_poses_jit``,
``solve_tag_bundle_jit``, ``detect_tags_jit``), and SQPnP without a
status read on the host: the 3x3 solve as an unrolled Cholesky, kernel
K3's plain version (``eig9_plain``) for Omega's eigenvectors and the
DLT's null vector, K2's plain version for the projection to SO(3).

Against the JAX package, on the CPU:
  * ``eig9_plain`` against ``jnp.linalg.eigh`` on 16 float32 Omegas built
    as ``solve_pnp_sqpnp`` builds them (12 points under 0.3 px of noise,
    8 general and 8 coplanar layouts): eigenvalues within 1e-5 of the
    largest |eigenvalue| (measured 7.2e-7); eigenvectors up to sign,
    1 - |v.v'| <= 1e-5 where the eigenvalue's gap to its neighbours
    exceeds 1e-4 of the largest (measured 4.8e-7; below that gap a vector
    turns freely inside its near-degenerate subspace);
  * the unrolled 3x3 Cholesky (``_chol_solve``) against
    ``jnp.linalg.solve`` on SQPnP's SW + 1e-12 I with SWA's 9 right-hand
    sides: within 1e-5 of the solution's largest entry (measured 3.1e-7);
  * the card's nearest rotation, ``kabsch3_plain(M^T)``, against
    ``_nearest_rotation(M)`` on 64 Gaussian matrices, 30 of them with
    det < 0: within 1e-6 in float64, 4e-6 in float32 (measured 8.0e-7,
    a few ulps of two LAPACK SVDs), and the reference's
    ``_nearest_rotation`` likewise;
  * the card's DLT null vector, the smallest eigenvector of the float64
    Gram (``_gram_null_vector``), against the JAX SVD's null vector up to
    sign: within 1e-5;
  * ``solve_pnp_sqpnp`` and ``solve_tag_bundle`` with the card's
    algorithms run on the CPU (``_nearest_rotation_k2`` and
    ``_gram_null_vector`` through the kernels' plain versions) against
    the JAX package under ``tests/test_torch_sqpnp.py``'s tolerances: the
    chosen R within 0.01 degrees, t within 0.1 mm, error within 1e-3 px;
    the coplanar cloud within 0.3 degrees and 0.5 mm (that file's
    docstring says why). Only the chosen pose is compared, never the
    candidates: the eigenvector seeds have sign and subspace freedom.
The CPU path itself (LAPACK's eigh, the SVDs) is held against the JAX
package by ``tests/test_torch_sqpnp.py``, at its tolerances.

Without JAX: each compiled step is a ``core.jit.Jitted`` over its plain
function with the recorded static, scalar and array arguments, runs that
function on the CPU (outputs bit-equal), takes a numpy ``K`` (the key
and the outputs of the tensor's call), and refuses a non-static Python
argument with TypeError; the eager ``process_frames`` calls no compiled
step (``Jitted.__call__`` raising).

Budget: under 15 s on one worker (JAX compiles SQPnP and the bundle).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.pose import bundle as JB  # noqa: E402
from repas_tpu.pose import pnp as JP  # noqa: E402
from repas_tpu_torch.core.jit import Jitted  # noqa: E402
from repas_tpu_torch.detect import detector as TD  # noqa: E402
from repas_tpu_torch.detect.render import example_frame  # noqa: E402
from repas_tpu_torch.graft_entry import DRYRUN_DETECTOR  # noqa: E402
from repas_tpu_torch.kernels.eig9 import eig9, eig9_plain  # noqa: E402
from repas_tpu_torch.kernels.kabsch3 import kabsch3_plain  # noqa: E402
from repas_tpu_torch.kernels.project import project_points  # noqa: E402
from repas_tpu_torch.pipeline import process_frames  # noqa: E402
from repas_tpu_torch.core.config import PipelineConfig  # noqa: E402
from repas_tpu_torch.pose import bundle as TB  # noqa: E402
from repas_tpu_torch.pose import fusion as TF  # noqa: E402
from repas_tpu_torch.pose import pnp as TP  # noqa: E402
from test_torch_sqpnp import (DIST, K, TAG, _angle_deg,  # noqa: E402
                              _bundle_case, _same_pose, _sqpnp_case)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _omega(obj, img):
    """(SW, SWA, Omega) float32 of solve_pnp_sqpnp for an undistorted
    camera and unit weights, in numpy."""
    xy = np.stack([(img[:, 0] - K[0, 2]) / K[0, 0],
                   (img[:, 1] - K[1, 2]) / K[1, 1]], -1).astype(np.float32)
    u = np.concatenate([xy, np.ones((len(xy), 1), np.float32)], 1)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    W = np.eye(3, dtype=np.float32)[None] - u[:, :, None] * u[:, None, :]
    A = np.einsum("ab,nc->nabc", np.eye(3, dtype=np.float32),
                  obj).reshape(len(obj), 3, 9)
    SW, SWA = W.sum(0), np.einsum("nij,njk->ik", W, A)
    T = -np.linalg.solve(SW.astype(np.float64) + 1e-12 * np.eye(3), SWA)
    M = (A + T[None]).astype(np.float32)
    return SW, SWA, np.einsum("nia,nij,njb->ab", M, W, M).astype(np.float32)


@pytest.mark.parametrize("kind", ["general", "coplanar"])
def test_eig9_plain_vs_reference_on_sqpnp_omegas(kind):
    rng = np.random.default_rng({"general": 11, "coplanar": 12}[kind])
    Om = np.stack([_omega(*_sqpnp_case(kind, rng)[:2])[2]
                   for _ in range(8)])
    wj, Vj = (np.asarray(x) for x in jax.vmap(jnp.linalg.eigh)(
        jnp.asarray(Om)))
    wt, Vt = (x.numpy() for x in eig9(_t(Om)))      # the CPU: eig9_plain
    top = np.abs(wj).max(axis=1, keepdims=True)
    assert (np.abs(wt - wj) <= 1e-5 * top).all()
    assert (np.diff(wt, axis=1) >= 0).all()
    d = np.diff(wj, axis=1) / top
    inf = np.full((len(wj), 1), np.inf)
    gap = np.minimum(np.concatenate([inf, d], 1), np.concatenate([d, inf], 1))
    dots = np.abs(np.einsum("nij,nij->nj", Vt, Vj))
    assert (gap > 1e-4).sum() >= 40
    assert (1 - dots[gap > 1e-4] <= 1e-5).all()


def test_chol_solve3_vs_reference():
    rng = np.random.default_rng(13)
    for kind in ("general", "coplanar"):
        SW, SWA, _ = _omega(*_sqpnp_case(kind, rng)[:2])
        A = SW + np.float32(1e-12) * np.eye(3, dtype=np.float32)
        want = np.asarray(jnp.linalg.solve(jnp.asarray(A), jnp.asarray(SWA)))
        got = TP._chol_solve(_t(A), _t(SWA)).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-6),
                                       (np.float32, 4e-6)])
def test_nearest_rotation_through_kabsch3_plain(dtype, tol):
    M = np.random.default_rng(14).normal(size=(64, 3, 3)).astype(dtype)
    assert 20 <= int((np.linalg.det(M) < 0).sum()) <= 44
    want = TP._nearest_rotation(_t(M)).numpy()
    got = kabsch3_plain(_t(M).mT).numpy()
    assert np.abs(got - want).max() <= tol
    assert np.abs(TP._nearest_rotation_k2(_t(M)).numpy() - want).max() <= \
        max(tol, 4e-6)
    ref = np.stack([np.asarray(JP._nearest_rotation(jnp.asarray(m)))
                    for m in M[:8].astype(np.float32)])
    assert np.abs(got[:8] - ref).max() <= 4e-6
    assert np.abs(np.linalg.det(got.astype(np.float64)) - 1).max() <= 1e-5


def test_gram_null_vector_vs_reference_svd():
    rng = np.random.default_rng(15)
    for kind in ("general", "coplanar"):
        obj, img = _sqpnp_case(kind, rng)[:2]
        xy = (img - K[:2, 2]) / np.diag(K)[:2]
        x, y, u, v = obj[:, 0], obj[:, 1], xy[:, 0], xy[:, 1]
        one, zero = np.ones_like(x), np.zeros_like(x)
        Ah = np.concatenate([
            np.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], 1),
            np.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], 1)],
            0).astype(np.float32)
        want = np.asarray(jnp.linalg.svd(jnp.asarray(Ah),
                                         full_matrices=False)[2][-1])
        got = TP._gram_null_vector(_t(Ah)).numpy()
        assert got.dtype == np.float32
        assert 1 - abs(float(got @ want)) <= 1e-5


@pytest.fixture
def card_algorithms(monkeypatch):
    """solve_pnp_sqpnp's card path on the CPU: the nearest rotation
    through K2's wrapper and the DLT null vector from the Gram through
    K3's (their plain versions on the CPU)."""
    monkeypatch.setattr(TP, "_nearest_rotation", TP._nearest_rotation_k2)
    monkeypatch.setattr(TP, "_dlt_null_vector", TP._gram_null_vector)


@pytest.mark.parametrize("kind", ["general", "coplanar"])
def test_sqpnp_card_algorithms_vs_reference(kind, card_algorithms):
    rng = np.random.default_rng({"general": 7, "coplanar": 9}[kind])
    obj, img, _, rvec, t = _sqpnp_case(kind, rng)
    Rj, tj, ej = JP.solve_pnp_sqpnp(jnp.asarray(obj), jnp.asarray(img),
                                    jnp.asarray(K), jnp.asarray(DIST))
    Rt, tt, et = TP.solve_pnp_sqpnp_jit(_t(obj), _t(img), K, _t(DIST))
    _same_pose(Rt.numpy(), tt.numpy(), et.numpy(), Rj, tj, ej,
               **({"r_deg": 0.3, "t_m": 5e-4} if kind == "coplanar"
                  else {}))
    assert float(et) < 1.0 and np.abs(tt.numpy() - t).max() < 2e-2


def test_bundle_card_algorithms_vs_reference(card_algorithms):
    corners, cpx, valid, centers, rvec, t = _bundle_case(1, 0.2)
    Rj, tj, ej = JB.solve_tag_bundle(jnp.asarray(corners), jnp.asarray(cpx),
                                     jnp.asarray(valid), jnp.asarray(centers),
                                     TAG, jnp.asarray(K))
    Rt, tt, et = TB.solve_tag_bundle_jit(_t(corners), _t(cpx), _t(valid),
                                         _t(centers), TAG, K)
    _same_pose(Rt.numpy(), tt.numpy(), et.numpy(), Rj, tj, ej)
    assert np.abs(tt.numpy() - t).max() < 3e-3


# --- the compiled steps on the CPU (no JAX below) --------------------------

def _tags(n, seed=0):
    """(corners (n,4,2) of 30 mm tags at 0.4-0.8 m, their rvecs, ts)."""
    rng = np.random.default_rng(seed)
    rv = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(0.4, 0.8, n)], 1).astype(np.float32)
    obj = TP.square_object_points(TAG, "cpu")
    c = project_points(obj, _t(rv), _t(t), _t(K))
    return c + _t(rng.normal(0, 0.1, c.shape).astype(np.float32)), rv, t


def _case(name):
    """(step, plain function, args with K as numpy, kwargs, static,
    scalar and array argument names)."""
    corners, rv, t = _tags(4)
    if name == "solve_pnp_ippe_square":
        return (TP.solve_pnp_ippe_square_jit, TP.solve_pnp_ippe_square,
                (corners, K, TAG), {"refine_iters": 4, "dist": _t(DIST)},
                {"tag_size_m", "refine_iters"}, set(), {"K", "dist"})
    if name == "refine_pnp_gn":
        obj = TP.square_object_points(TAG, "cpu")
        return (TP.refine_pnp_gn_jit, TP.refine_pnp_gn,
                (obj, corners, _t(rv + 0.02), _t(t + 0.01), K),
                {"iters": 4, "damping": 1e-5},
                {"iters"}, {"damping"}, {"K", "dist"})
    if name == "solve_pnp_sqpnp":
        obj, img, w, _, _ = _sqpnp_case("weighted", np.random.default_rng(3))
        return (TP.solve_pnp_sqpnp_jit, TP.solve_pnp_sqpnp,
                (_t(obj), _t(img), K, _t(DIST)),
                {"refine_iters": 5, "weights": _t(w)},
                {"refine_iters"}, set(), {"K", "dist"})
    if name == "solve_pnp_best_order":
        return (TP.solve_pnp_best_order_jit, TP.solve_pnp_best_order,
                (corners[:, [1, 2, 3, 0]], K, TAG),
                {"z_penalty": 500.0, "refine_iters": 3},
                {"tag_size_m", "refine_iters"}, {"z_penalty"},
                {"K", "dist"})
    if name == "fuse_tag_poses":
        depth = torch.full((1, 48, 64), 0.6)
        return (TF.fuse_tag_poses_jit, TF.fuse_tag_poses,
                (corners[None], torch.tensor([[16, 9, 3, 5]]),
                 torch.full((1, 4), 400.0),
                 torch.tensor([[True, True, True, False]]),
                 depth, K, TAG),
                {"try_all_orders": True, "flip_z_ids": (9,)},
                {"tag_size_m", "anchor_id", "flip_z_ids", "win",
                 "try_all_orders"}, set(), {"K", "dist"})
    if name == "solve_tag_bundle":
        c, cpx, valid, centers, _, _ = _bundle_case(2, 0.2)
        return (TB.solve_tag_bundle_jit, TB.solve_tag_bundle,
                (_t(c), _t(cpx), _t(valid), _t(centers), TAG, K), {},
                {"tag_size_m"}, set(), {"K", "dist"})
    rgb, _, _ = example_frame(96, 128)
    return (TD.detect_tags_jit, TD.detect_tags,
            (_t(np.stack([rgb, rgb[:, ::-1]])), DRYRUN_DETECTOR),
            {"with_candidates": True}, {"config", "with_candidates"},
            set(), set())


STEPS = ["solve_pnp_ippe_square", "refine_pnp_gn", "solve_pnp_sqpnp",
         "solve_pnp_best_order", "fuse_tag_poses", "solve_tag_bundle",
         "detect_tags"]


def _equal(a, b):
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))


def _tensor_k(args):
    return tuple(_t(a) if isinstance(a, np.ndarray) else a for a in args)


@pytest.mark.parametrize("name", STEPS)
def test_compiled_step_runs_its_plain_function_on_the_cpu(name):
    step, plain, args, kw, static, scalar, array = _case(name)
    assert isinstance(step, Jitted) and step.fn is plain
    assert not isinstance(plain, Jitted)
    assert (set(step.static_argnames), set(step.scalar_argnames),
            set(step.array_argnames)) == (static, scalar, array)
    want = plain(*_tensor_k(args), **kw)
    assert _equal(step(*args, **kw), want)           # numpy K, if any
    assert _equal(step(*_tensor_k(args), **kw), want)
    assert step.key(*args, **kw) == step.key(*_tensor_k(args), **kw)


@pytest.mark.parametrize("name", STEPS)
def test_compiled_step_refuses_a_python_argument(name):
    step, _, args, kw, *_ = _case(name)
    if name == "detect_tags":
        bad = (args[0].numpy(), *args[1:])            # a host image
    else:                                             # K as nested lists
        bad = tuple(a.tolist() if isinstance(a, np.ndarray) else a
                    for a in args)
    with pytest.raises(TypeError, match="neither a tensor nor static"):
        step(*bad, **kw)


def test_eager_process_frames_calls_no_compiled_step(monkeypatch):
    def refuse(self, *args, **kwargs):
        raise AssertionError(f"the eager process_frames called {self.name}")

    monkeypatch.setattr(Jitted, "__call__", refuse)
    rgb, depth, Kf = example_frame(96, 128)
    out = process_frames(_t(rgb[None]), _t(depth[None]), Kf,
                         PipelineConfig(detector=DRYRUN_DETECTOR))
    assert int(out.detections.ids[0, 0]) == 9
    assert _angle_deg(np.eye(3), out.pose.R_avg[0].numpy()) < 180
