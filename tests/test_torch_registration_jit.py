"""The registration path as compiled steps (``core.jit``): the plain
versions of kernels K1 (``kernels/eig3.py``) and K2
(``kernels/kabsch3.py``), ICP over ``core.jit.while_loop(...,
unroll=False)`` (one WHILE graph node on the card, a Python loop here),
RANSAC's draws outside its compiled step, the scalar arguments that a
step takes as 0-d tensors, and the row-chunked sampled steps.

Against the JAX package on the CPU, with numpy inputs from a seed:
  * eig3's plain version and jnp.linalg.eigh: eigenvalues within 1e-5 of
    the largest; where the two smallest eigenvalues are 1e-3 of the
    largest apart, the smallest eigenvectors within 1e-4 rad (both
    float32 solvers, each rounding at 1e-7 of the largest eigenvalue);
    elsewhere (near-degenerate) the residual |Av - lv| within 1e-5 |A|
    and the columns orthonormal within 1e-5;
  * the port's _kabsch (K2's plain version inside) and the reference's
    (both float32 SVDs, whose error of a few ulps of H moves R by that
    over r = (sigma2 + sigma3) / sigma1): R and t within 1e-5 where r >
    1e-2; |dR| r within 1e-6 where sigma2 > 1e-6 sigma1; det R = 1 within
    1e-5 on every triple, collinear and repeated points included (there
    R is not unique);
  * ICP written through the WHILE path and the reference's
    lax.while_loop on a 2k-point pair (rel_tol 1e-5): the same
    iterations, T within 1e-5 m and 1e-3 degrees
    (tests/test_torch_registration.py's tolerances); with masked source
    points (C9: the RMSE is NaN) both run to max_iters.
The rest is the port against itself, bit for bit: the compiled pieces'
functions given their floats as 0-d float32 tensors and as Python
floats; ransac_registration and its draws followed by the scoring
step's function; chunked and unchunked sampled normals and outlier
masks; while_loop(unroll=False)'s CPU semantics.

Budget: under 30 s on one worker (JAX compiles ICP twice).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import fpfh as JF  # noqa: E402
from repas_tpu.cloud import registration as JR  # noqa: E402
from repas_tpu_torch.cloud import filters as F  # noqa: E402
from repas_tpu_torch.cloud import fpfh as PF  # noqa: E402
from repas_tpu_torch.cloud import normals as N  # noqa: E402
from repas_tpu_torch.cloud import registration as PR  # noqa: E402
from repas_tpu_torch.core.jit import Jitted, jit, while_loop  # noqa: E402
from repas_tpu_torch.core.transforms import make_T, rodrigues  # noqa: E402
from repas_tpu_torch.kernels.eig3 import eig3  # noqa: E402
from repas_tpu_torch.kernels.kabsch3 import kabsch3  # noqa: E402
from test_torch_registration import _assert_close_T, _icp_scene  # noqa


def _covariances(seed, n=600):
    """Neighbourhood covariances: planar, linear (two eigenvalues near
    0), isotropic (three equal), exactly repeated and zero, each with the
    ridge _pca_normals adds."""
    rng = np.random.default_rng(seed)
    scales = [(1, 1, 1e-3), (1, 1e-4, 1e-4), (1, 1, 1), (1, 0.3, 0.01)]
    out = []
    for i in range(n):
        pts = rng.normal(size=(16, 3)) * scales[i % 4]
        pts = pts @ np.linalg.qr(rng.normal(size=(3, 3)))[0]
        d = pts - pts.mean(0)
        out.append(d.T @ d)
    out.append(np.diag([2.0, 2.0, 2.0]))
    out.append(np.zeros((3, 3)))
    A = np.stack(out).astype(np.float32)
    tr = np.trace(A, axis1=1, axis2=2)[:, None, None]
    return (A + np.float32(1e-12) * (tr + np.float32(1e-30))
            * np.eye(3, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_eig3_plain_matches_jnp_eigh(seed):
    A = _covariances(seed)
    w, V = (x.numpy().astype(np.float64) for x in eig3(torch.from_numpy(A)))
    wj, Vj = (np.asarray(x, np.float64) for x in jnp.linalg.eigh(A))
    top = np.abs(wj).max(axis=1)
    assert (np.abs(w - wj).max(axis=1) <= 1e-5 * top + 1e-30).all()
    assert (np.diff(w, axis=1) >= 0).all()
    clear = (wj[:, 1] - wj[:, 0]) > 1e-3 * top
    a, b = V[:, :, 0], Vj[:, :, 0]
    angle = np.arctan2(np.linalg.norm(np.cross(a, b), axis=1),
                       np.abs(np.sum(a * b, axis=1)))
    assert clear.sum() > 200
    assert (angle[clear] <= 1e-4).all()
    A64 = A.astype(np.float64)
    res = np.linalg.norm(A64 @ V - V * w[:, None, :], axis=1).max(axis=1)
    norm = np.linalg.norm(A64, axis=(1, 2))
    assert (res <= 1e-5 * norm + 1e-30).all()
    eye = np.abs(np.swapaxes(V, 1, 2) @ V - np.eye(3)).max(axis=(1, 2))
    assert (eye <= 1e-5).all()


def _triples(seed, n=500):
    """Point triples P, Q: general, two points repeated (rank 1), three
    collinear, one point at the centroid of the other two (collinear),
    and all three equal (H = 0)."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.1
    Q = P @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T.astype(np.float32)
    Q = (Q + rng.normal(0, 0.01, (n, 3, 3)) + 0.3).astype(np.float32)
    P[1::5, 2] = P[1::5, 1]
    P[2::5, 2] = P[2::5, 0] + np.float32(0.4) * (P[2::5, 1] - P[2::5, 0])
    P[3::5, 2] = (P[3::5, 0] + P[3::5, 1]) * np.float32(0.5)
    P[4::25] = P[4::25, :1]
    return P.astype(np.float32), Q.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_kabsch_plain_matches_reference(seed):
    P, Q = _triples(seed)
    R, t = (x.numpy() for x in PF._kabsch(torch.from_numpy(P),
                                           torch.from_numpy(Q)))
    Rj, tj = (np.asarray(x) for x in jax.vmap(JF._kabsch)(jnp.asarray(P),
                                                            jnp.asarray(Q)))
    cp = P - P.mean(axis=1, keepdims=True)
    cq = Q - Q.mean(axis=1, keepdims=True)
    s = np.linalg.svd(np.swapaxes(cp, 1, 2).astype(np.float64) @ cq,
                      compute_uv=False)
    r = (s[:, 1] + s[:, 2]) / np.maximum(s[:, 0], 1e-300)
    err = np.abs(R - Rj).max(axis=(1, 2))
    clear = r > 1e-2
    assert 100 < clear.sum() < len(P)
    assert err[clear].max() <= 1e-5
    assert np.abs(t - tj)[clear].max() <= 1e-5
    # both float32 SVDs err by a few ulps of H; R moves by that over
    # (sigma2 + sigma3) / sigma1
    tier = s[:, 1] > 1e-6 * s[:, 0]
    assert (err * r)[tier].max() <= 1e-6
    det = np.linalg.det(R.astype(np.float64))
    assert np.abs(det - 1.0).max() <= 1e-5
    # K2's plain version is _kabsch's rotation from H
    H = torch.from_numpy(np.swapaxes(cp, 1, 2) @ cq)
    assert kabsch3(H).shape == (len(P), 3, 3)


def _icp(port, src, mask, base, nrm, **kw):
    if port:
        return PR.icp_point_to_plane(*(torch.from_numpy(a) for a in
                                       (src, mask, base, np.ones_like(mask),
                                        nrm)), **kw)
    return JR.icp_point_to_plane(*(jnp.asarray(a) for a in
                                   (src, mask, base, np.ones_like(mask),
                                    nrm)), **kw)


def test_icp_while_path_matches_reference():
    """The ICP step's loop is while_loop(unroll=False); here a Python
    loop. T_init puts the pair 1.2 cm and 0.9 degrees off, the source
    carries 1 mm of noise. rel_tol is 1e-5: at the default 1e-6 the
    converging step is decided by the float32 RMSE's last bits, which
    the 6x6 normal equations' summation order moves
    (tests/test_torch_registration.py holds that case within 2 steps)."""
    rng = np.random.default_rng(5)
    src, base, nrm, _, _ = _icp_scene(rng)
    src = (src + rng.normal(0, 1e-3, src.shape)).astype(np.float32)
    mask = np.ones(len(src), bool)
    T_init = np.asarray(make_T(rodrigues(torch.tensor([0.0, 0.01, -0.01])),
                               torch.tensor([0.004, 0.0, 0.002])))
    kw = dict(max_corr_dist=0.05, max_iters=30, rel_tol=1e-5,
              dims=(32, 32, 32), T_init=T_init)
    rt, rj = _icp(True, src, mask, base, nrm, **kw), \
        _icp(False, src, mask, base, nrm, **kw)
    assert rt.iterations == int(rj.iterations) < 30
    _assert_close_T(rt.T.numpy(), rj.T, 1e-5, 1e-3)
    assert abs(float(rt.fitness) - float(rj.fitness)) <= 1e-4

    # C9: masked source points make the RMSE NaN, so neither converges
    part = mask.copy()
    part[::7] = False
    kw.update(max_iters=6)
    rt, rj = _icp(True, src, part, base, nrm, **kw), \
        _icp(False, src, part, base, nrm, **kw)
    assert rt.iterations == int(rj.iterations) == 6
    assert math.isnan(float(rt.inlier_rmse))
    assert math.isnan(float(rj.inlier_rmse))
    _assert_close_T(rt.T.numpy(), rj.T, 1e-5, 1e-3)


@pytest.mark.parametrize("seed", [3, 11])
def test_ransac_draws_outside_the_step_equal_the_eager_function(seed):
    rng = np.random.default_rng(seed)
    n = 400
    src = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    tgt = src @ torch.from_numpy(np.linalg.qr(rng.normal(size=(3, 3)))[0]
                                 .astype(np.float32)).T + 0.1
    mask = torch.from_numpy(rng.random(n) > 0.1)
    corr = torch.from_numpy(np.where(rng.random(n) > 0.3, np.arange(n),
                                     rng.integers(0, n, n)).astype(np.int32))
    T, fit = PF.ransac_registration(src, mask, tgt, mask, corr, 0.05,
                                    n_hypotheses=256, eval_points=128,
                                    key=seed)
    # the draws, then the step's function: the eager ransac_registration
    ok = mask & (corr >= 0)
    gen = F._generator("cpu", seed)
    picks = F._choice(ok, 3 * 256, True, gen).reshape(256, 3)
    ev = F._choice(ok, 128, True, gen)
    assert isinstance(PF._ransac_from_picks, Jitted)
    T2, fit2, _, _ = PF._ransac_from_picks.fn(src, mask, tgt, mask, corr,
                                              0.05, 0.9, picks, ev)
    assert torch.equal(T, T2) and torch.equal(fit, fit2)
    assert float(fit) > 0.3


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.2, 0.2, (n, 2))
    z = 0.5 + 0.05 * np.sin(8 * u[:, 0]) + rng.normal(0, 1e-3, n)
    pts = torch.from_numpy(np.c_[u, z].astype(np.float32))
    return pts, torch.from_numpy(rng.random(n) > 0.1)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    if a is None or isinstance(a, int):
        return a == b
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("fn", ["voxel_downsample", "estimate_normals_grid",
                                "fpfh_features", "icp_point_to_plane",
                                "evaluate_registration"])
def test_floats_as_tensors_equal_python_floats(fn):
    pts, mask = _cloud(2, 1500)
    nrm, _ = N.estimate_normals_grid(pts, mask, k=12, radius=0.03,
                                     dims=(16, 16, 16), slots=16)
    moved = pts + torch.tensor([0.004, -0.002, 0.001])
    T0 = np.eye(4, dtype=np.float32)
    calls = {
        "voxel_downsample": lambda x: F.voxel_downsample(pts, mask, x,
                                                         normals=nrm),
        "estimate_normals_grid": lambda x: N.estimate_normals_grid(
            pts, mask, k=12, radius=x, dims=(16, 16, 16), slots=16),
        "fpfh_features": lambda x: PF.fpfh_features(
            pts, nrm, mask, radius=x, k=16, dims=(16, 16, 16), slots=16),
        "icp_point_to_plane": lambda x: PR.icp_point_to_plane(
            moved, mask, pts, mask, nrm, max_corr_dist=x, max_iters=10,
            rel_tol=x * 1e-4, dims=(16, 16, 16)),
        "evaluate_registration": lambda x: PR.evaluate_registration(
            moved, mask, pts, mask, T0, max_corr_dist=x, dims=(16, 16, 16)),
    }
    value = {"voxel_downsample": 0.011}.get(fn, 0.031)
    a = calls[fn](value)
    b = (calls[fn](_f32(value)) if fn != "icp_point_to_plane" else
         PR.icp_point_to_plane(moved, mask, pts, mask, nrm,
                               max_corr_dist=_f32(value), max_iters=10,
                               rel_tol=_f32(value * 1e-4),
                               dims=(16, 16, 16)))
    assert _equal(tuple(a), tuple(b))


def test_scalar_arguments_key_as_tensors():
    """A compiled step keys a Python float and a 0-d float32 tensor for a
    scalar argument the same way (JAX traces both); on the CPU the step
    gets the float as it was given."""
    seen = []

    def f(x, s):
        seen.append(type(s))
        return x * s

    step = jit(f, scalar_argnames=("s",))
    x = torch.ones(3)
    assert step.key(x, 2.0) == step.key(x, _f32(3.0))
    assert step.key(x, 2.0) != step.key(x[:2], 2.0)
    assert torch.equal(step(x, 2.0), step(x, _f32(2.0)))
    assert seen == [float, torch.Tensor]
    with pytest.raises(ValueError, match="scalar_argnames"):
        jit(f, scalar_argnames=("t",))


@pytest.mark.parametrize("n,rows", [(3000, 700), (2500, 64)])
def test_sampled_steps_by_row_chunks_are_bit_equal(n, rows):
    pts, mask = _cloud(4, n)
    idx = torch.from_numpy(np.random.default_rng(4).choice(n, 512, False))
    whole = N._normals_from_sample(pts, mask, idx, 16, 0.05, rows=n)
    parts = N._normals_from_sample(pts, mask, idx, 16, 0.05, rows=rows)
    assert torch.equal(whole[0], parts[0])
    assert torch.equal(whole[1], parts[1])
    assert whole[1].float().mean() > 0.5
    a = F._outlier_mask_from_sample(pts, mask, idx, 20, 2.0, rows=n)
    b = F._outlier_mask_from_sample(pts, mask, idx, 20, 2.0, rows=rows)
    assert torch.equal(a, b) and 0 < int((mask & ~a).sum())


def _double(s):
    return s[0] * 2.0 + 1.0, s[1] + 1


@pytest.mark.parametrize("n", [0, 1, 4])
def test_while_path_equals_python_loop(n):
    x0 = torch.arange(3, dtype=torch.float32)
    tests = []
    x, i = while_loop(lambda s: s[1] < n, _double, (x0, torch.tensor(0)),
                      max_trips=4, on_test=lambda: tests.append(1),
                      unroll=False)
    want = x0
    for _ in range(n):
        want = want * 2.0 + 1.0
    assert torch.equal(x, want) and int(i) == n and len(tests) == n + 1


def test_while_path_bound_and_structure():
    with pytest.raises(RuntimeError, match="max_trips=2"):
        while_loop(lambda s: s[1] < 5, _double,
                   (torch.zeros(2), torch.tensor(0)), max_trips=2,
                   unroll=False)
    with pytest.raises(ValueError, match="structure, shapes or dtypes"):
        while_loop(lambda s: s[1] < 5, lambda s: (s[0][:1], s[1] + 1),
                   (torch.zeros(2), torch.tensor(0)), max_trips=3,
                   unroll=False)
