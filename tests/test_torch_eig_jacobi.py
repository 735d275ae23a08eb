"""The algorithms of kernels K3 (``kernels/csrc/eig9.cu``), K1
(``kernels/csrc/eig3.cu``) and K2 (``kernels/csrc/kabsch3.cu``), which
run only on the card, as float64 torch models on the CPU, against LAPACK
(``torch.linalg.eigh``; K2 against ``kabsch3_plain``, LAPACK's SVD).

Each model follows its ``.cu`` step for step: the rotation of
``csrc/jacobi.cuh`` (two rsqrt, no division; skipped, a_pq set to 0,
where a_pq^2 is under DBL_MIN), the stopping rule (squared off-diagonal
norm at or under 1e-30 of the squared Frobenius norm, or 16 sweeps for
K3 and 8 for K1), and the final order (K3: by eigenvalue, ties by
index, NaN last; K1: the 3-comparator network). K3 scales its matrix by
an even power of two first and runs each sweep as 9 rounds of 4 disjoint
pairs of the round-robin order (row k meets row (2R - k) mod 9 in round
R); K1 runs the cyclic (0,1), (0,2), (1,2) order and only sets to 0 a
pair whose 3 a_pq^2 is at or under that floor. A round's rotations
commute, so the model applies them as one product J^T A J, then sets
each pair's 2x2 block to its Schur values with a_pq exactly 0, as the
kernel does.

Inputs: the Omegas (float32) and DLT Gram matrices (float64) that
SQPnP's CPU path forms, for non-coplanar problems and for the tag
bundle's coplanar layout (``tests/test_torch_sqpnp.py``'s cases); the
clustered spectra, the zero matrix and the identity of
``tests/test_torch_cuda_kernels.py``'s ``_symmetric9``; its
``_covariances`` (planar, linear, isotropic, thin planar, 2 I, 0), a
zero matrix and the identity.

Tolerances are ``chip_smoke.py``'s gates. ``check_k3``: against LAPACK
in float64, eigenvalues within 1e-5 of the largest |eigenvalue| (1e-12
for a float64 input), eigenvectors up to sign, 1 - |v.v'| within 1e-6
(1e-10) where the eigenvalue's gap to its neighbours is over 1e-4 of the
largest; against LAPACK in the input's type, eigenvalues within 1e-5,
vectors within 1e-5 where the gap is over 1e-3; |AV - VL| within 1e-5
|A| and V orthonormal within 1e-5 everywhere; at most 16 sweeps.
``check_k1``: against LAPACK in float64 and in float32, eigenvalues
within 1e-5 of the largest; the smallest eigenvector within 1e-4 rad of
float64's where the two smallest eigenvalues are over 1e-6 of the trace
apart, within 1e-4 rad of float32's where over 1e-3, and angle x gap /
trace within 1e-6 where over 1e-6; elsewhere |Av - lv| within 1e-5 |A|.

K2's model runs the one-sided Jacobi on H's column pairs with the same
rotation of each pair's Gram block, skipped where g^2 <= 1e-30 a b, until
a sweep rotates nothing (at most 10), then sorts the columns by squared
norm and normalises by rsqrt (``kabsch3_model``). Its inputs: one RANSAC
draw's 8,192 triples (``_kabsch_triples``: repeated picks, collinear
triples, H = 0), collinear triples, and the transposed seeds SQPnP
projects to SO(3) in ``tests/test_torch_sqpnp.py``'s cases
(non-coplanar, coplanar, the bundle; the sign-flipped seeds among
them). Its gates: ``check_k2``'s (R within 1e-5 of float64's where
sigma2 > 1e-6 sigma1, det R = 1 within 1e-5; within 1e-5 of float32's
where (sigma2 + sigma3) / sigma1 > 1e-2, and that ratio times the
difference within 1e-6) and ``check_k2_pnp``'s (R within 1e-5 where
the rotation is determined, the Kabsch objective within 1e-6 and R
orthonormal with det 1 everywhere).

Budget: under 5 s on one worker.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")            # tests/test_torch_sqpnp.py's cases

from repas_tpu_torch.kernels.eig9 import eig9_plain  # noqa: E402
from repas_tpu_torch.kernels.kabsch3 import kabsch3_plain  # noqa: E402
from repas_tpu_torch.pose import bundle as TB  # noqa: E402
from repas_tpu_torch.pose import pnp as TP  # noqa: E402
from test_torch_cuda_kernels import (_covariances,  # noqa: E402
                                     _kabsch_triples, _symmetric9)
from test_torch_sqpnp import (DIST, K, TAG, _bundle_case,  # noqa: E402
                              _sqpnp_case, _t)

F64 = torch.float64
DBL_MIN = torch.finfo(F64).tiny


def rotation(app, aqq, apq):
    """csrc/jacobi.cuh: (c, s, t a_pq) of the rotation zeroing a_pq, and
    whether it rotates (a_pq^2 at or over DBL_MIN)."""
    aa = apq * apq
    rot = aa >= DBL_MIN
    h = 0.5 * (aqq - app)
    x = h * h + aa
    r = x * torch.rsqrt(x)
    u = h.abs() + r
    w = torch.rsqrt(u * u + aa)
    p = apq * w
    s = torch.where(torch.signbit(h), -p, p)
    ta = s * p * (r + r)
    one, zero = torch.ones_like(app), torch.zeros_like(app)
    return (torch.where(rot, u * w, one), torch.where(rot, s, zero),
            torch.where(rot, ta, zero))


def round_robin(rows=9):
    """K3's rounds: in round R the pairs ((R + i) mod 9, (R - i) mod 9),
    i = 1..4, lower index first."""
    return [[tuple(sorted(((R + i) % rows, (R - i) % rows)))
             for i in range(1, (rows + 1) // 2)] for R in range(rows)]


def _symmetric_from_lower(A):
    A = A.to(F64)
    return torch.tril(A) + torch.tril(A, -1).mT


def _rotate_pairs(A, V, pairs, active, floor2=None):
    """One step: the pairs' rotations (disjoint, so they commute) as one
    J, A <- J^T A J with each pair's Schur values and a_pq = 0, V <- V J;
    matrices not `active` unchanged. With `floor2` (K1), a pair with
    3 a_pq^2 <= floor2 is only set to 0."""
    n, m = A.shape[0], A.shape[1]
    J = torch.eye(m, dtype=F64).repeat(n, 1, 1)
    fixes = []
    for p, q in pairs:
        c, s, ta = rotation(A[:, p, p], A[:, q, q], A[:, p, q])
        if floor2 is not None:
            small = ~(3.0 * A[:, p, q] * A[:, p, q] > floor2)
            c = torch.where(small, 1.0, c)
            s = torch.where(small, 0.0, s)
            ta = torch.where(small, 0.0, ta)
        J[:, p, p], J[:, q, q], J[:, p, q], J[:, q, p] = c, c, s, -s
        fixes.append((p, q, A[:, p, p] - ta, A[:, q, q] + ta))
    An = J.mT @ A @ J
    for p, q, dp, dq in fixes:
        An[:, p, p], An[:, q, q] = dp, dq
        An[:, p, q] = An[:, q, p] = 0.0
    keep = active[:, None, None]
    return torch.where(keep, An, A), torch.where(keep, V @ J, V)


def eig9_model(A):
    """K3's algorithm in float64: (w, V, sweeps) of (N,9,9) A, in A's
    type as the kernel rounds them at the store."""
    dtype = A.dtype
    A = _symmetric_from_lower(A)
    n = A.shape[0]
    mx = A.abs().amax((1, 2))
    e = torch.frexp(mx)[1].to(torch.int64)     # mx = f 2^e, f in [1/2, 1)
    e = torch.where((mx > 0) & torch.isfinite(mx), e + (e & 1), 0)
    A = torch.ldexp(A, -e[:, None, None].to(F64))
    eye = torch.eye(9, dtype=torch.bool)
    floor2 = 1e-30 * (A * A).sum((1, 2))
    V = torch.eye(9, dtype=F64).repeat(n, 1, 1)
    sweeps = torch.zeros(n, dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    while True:
        off = torch.where(eye, 0.0, A * A).sum((1, 2))
        active &= (off > floor2) & (sweeps < 16)
        if not bool(active.any()):
            break
        sweeps += active.to(torch.int32)
        for pairs in round_robin():
            A, V = _rotate_pairs(A, V, pairs, active)
    d = torch.diagonal(A, dim1=1, dim2=2)
    key = torch.where(torch.isnan(d), torch.inf, d)
    order = torch.argsort(key, dim=1, stable=True)
    w = torch.ldexp(torch.gather(d, 1, order), e[:, None].to(F64))
    V = torch.gather(V, 2, order[:, None, :].expand(-1, 9, -1))
    return w.to(dtype), V.to(dtype), sweeps


def eig3_model(A):
    """K1's algorithm in float64: (w, V, sweeps) of (N,3,3) float32 A,
    rounded to float32 as the kernel stores them."""
    A = _symmetric_from_lower(A)
    n = A.shape[0]
    eye = torch.eye(3, dtype=torch.bool)
    floor2 = 1e-30 * (A * A).sum((1, 2))
    V = torch.eye(3, dtype=F64).repeat(n, 1, 1)
    sweeps = torch.zeros(n, dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    for _ in range(8):
        off = torch.where(eye, 0.0, A * A).sum((1, 2)) / 2
        active &= off > floor2
        if not bool(active.any()):
            break
        sweeps += active.to(torch.int32)
        for pair in ((0, 1), (0, 2), (1, 2)):
            A, V = _rotate_pairs(A, V, [pair], active, floor2)
    d = torch.diagonal(A, dim1=1, dim2=2).clone()
    for i, j in ((0, 1), (1, 2), (0, 1)):         # the kernel's network
        swap = d[:, j] < d[:, i]
        d[:, [i, j]] = torch.where(swap[:, None], d[:, [j, i]], d[:, [i, j]])
        V[:, :, [i, j]] = torch.where(swap[:, None, None], V[:, :, [j, i]],
                                      V[:, :, [i, j]])
    return d.float(), V.float(), sweeps


def _det3(M):
    """The kernels' det3: the cofactor expansion along the first row."""
    return (M[:, 0, 0] * (M[:, 1, 1] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 1])
            - M[:, 0, 1] * (M[:, 1, 0] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 0])
            + M[:, 0, 2] * (M[:, 1, 0] * M[:, 2, 1] - M[:, 1, 1] * M[:, 2, 0]))


def kabsch3_model(H):
    """K2's algorithm in float64: (R, sweeps) of (N,3,3) float32 H, R
    rounded to float32 as the kernel stores it. One-sided Jacobi on H's
    column pairs (0,1), (0,2), (1,2), each rotated by csrc/jacobi.cuh's
    rotation of its Gram block (a, b the squared norms, g the dot
    product) unless g^2 <= 1e-30 a b (or g^2 under DBL_MIN); stop after a
    sweep that rotates nothing, or 10 sweeps. Then the columns sorted by
    squared norm x (the 3-comparator network), u1 = h1 rsqrt(x1), u2 =
    h2 rsqrt(x2) where x2 > 1e-26 x1, else u1 x e over its norm (e the
    axis u1 leans on least), u3 = u1 x u2; H = 0 gives U = V = I; R = V
    diag(1, 1, d) U^T with d the sign of det V det U."""
    h = H.to(F64).clone()
    n = h.shape[0]
    v = torch.eye(3, dtype=F64).repeat(n, 1, 1)
    sweeps = torch.zeros(n, dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    for _ in range(10):
        rotated = torch.zeros(n, dtype=torch.bool)
        for p, q in ((0, 1), (0, 2), (1, 2)):
            a = (h[:, :, p] * h[:, :, p]).sum(1)
            b = (h[:, :, q] * h[:, :, q]).sum(1)
            g = (h[:, :, p] * h[:, :, q]).sum(1)
            c, s, _ = rotation(a, b, g)
            rot = active & (g * g > 1e-30 * a * b) & (g * g >= DBL_MIN)
            c, s = c[:, None], s[:, None]
            for m in (h, v):
                mp, mq = m[:, :, p].clone(), m[:, :, q].clone()
                m[:, :, p] = torch.where(rot[:, None], c * mp - s * mq, mp)
                m[:, :, q] = torch.where(rot[:, None], s * mp + c * mq, mq)
            rotated |= rot
        active &= rotated
        sweeps += active.to(torch.int32)
        if not bool(active.any()):
            break
    x = (h * h).sum(1)
    for i, j in ((0, 1), (1, 2), (0, 1)):         # the kernel's network
        swap = x[:, j] > x[:, i]
        x[:, [i, j]] = torch.where(swap[:, None], x[:, [j, i]], x[:, [i, j]])
        for m in (h, v):
            m[:, :, [i, j]] = torch.where(swap[:, None, None],
                                          m[:, :, [j, i]], m[:, :, [i, j]])
    live = x[:, 0] > 0
    eye = torch.eye(3, dtype=F64)
    u1 = torch.where(live[:, None], h[:, :, 0] * torch.rsqrt(x[:, :1]),
                     eye[0])
    lean = u1.abs()
    e = torch.where((lean[:, 0] <= lean[:, 1]) & (lean[:, 0] <= lean[:, 2]),
                    0, torch.where(lean[:, 1] <= lean[:, 2], 1, 2))
    normal = torch.linalg.cross(u1, eye[e])
    normal = normal * torch.rsqrt((normal * normal).sum(1, keepdim=True))
    u2 = torch.where((x[:, 1] > 1e-26 * x[:, 0])[:, None],
                     h[:, :, 1] * torch.rsqrt(x[:, 1:2]), normal)
    u2 = torch.where(live[:, None], u2, eye[1])
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], 2)
    V = torch.where(live[:, None, None], v, eye)
    d = torch.where(_det3(V) * _det3(U) < 0, -1.0, 1.0)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], 1)
    return ((V * D[:, None, :]) @ U.mT).float(), sweeps


def _worst(x, sel):
    return float(x[sel].max()) if bool(sel.any()) else 0.0


def check_k3(A, w, V, sweeps):
    """chip_smoke.py's check_k3 gates on the model's result."""
    n = A.shape[0]
    f64 = A.dtype == F64
    w64, V64 = eig9_plain(A.double())
    wp, Vp = eig9_plain(A)
    top = w64.abs().amax(1, keepdim=True) + 1e-300
    d = (w64[:, 1:] - w64[:, :-1]) / top
    inf = torch.full((n, 1), float("inf"), dtype=F64)
    gap = torch.minimum(torch.cat([inf, d], 1), torch.cat([d, inf], 1))
    vec64 = 1 - (V.double() * V64).sum(1).abs()
    vecp = 1 - (V.double() * Vp.double()).sum(1).abs()
    Ad, Vd = A.double(), V.double()
    res = (Ad @ Vd - Vd * w.double()[:, None, :]).norm(dim=(1, 2)) / (
        Ad.norm(dim=(1, 2)) + 1e-300)
    assert w.dtype == V.dtype == A.dtype
    assert float(((w.double() - w64).abs() / top).max()) <= \
        (1e-12 if f64 else 1e-5)
    assert float(((w.double() - wp.double()).abs() / top).max()) <= 1e-5
    assert _worst(vec64, gap > 1e-4) <= \
        (1e-10 if f64 else 1e-6)
    assert _worst(vecp, gap > 1e-3) <= 1e-5
    assert float(res.max()) <= 1e-5
    assert float((Vd.mT @ Vd - torch.eye(9, dtype=F64)).abs().max()) <= 1e-5
    assert int(sweeps.max()) <= 16
    return int((gap > 1e-4).sum())


def _angle(a, b):
    """Angles (rad) between unit vectors (N,3) up to sign."""
    return torch.atan2(torch.linalg.cross(a, b).norm(dim=1),
                       (a * b).sum(1).abs())


def check_k1(A, w, V, sweeps):
    """chip_smoke.py's check_k1 gates on the model's result (eigenvectors
    up to sign in place of facing a camera)."""
    w64, V64 = torch.linalg.eigh(A.double())
    w32, V32 = torch.linalg.eigh(A)
    top = w64.abs().amax(dim=1) + 1e-30
    tr = w64.sum(dim=1).abs() + 1e-30
    gap = (w64[:, 1] - w64[:, 0]) / tr
    apart = gap > 1e-6
    ang64 = _angle(V[:, :, 0].double(), V64[:, :, 0])
    ang32 = _angle(V[:, :, 0].double(), V32[:, :, 0].double())
    Ad, Vd = A.double(), V.double()
    res = (Ad @ Vd - Vd * w.double()[:, None, :]).norm(dim=1).amax(dim=1) \
        / (Ad.norm(dim=(1, 2)) + 1e-30)
    assert float(((w.double() - w64).abs().amax(1) / top).max()) <= 1e-5
    assert float(((w - w32).double().abs().amax(1) / top).max()) <= 1e-5
    assert _worst(ang64, apart) <= 1e-4
    assert _worst(ang32, gap > 1e-3) <= 1e-4
    assert _worst(ang32 * gap, apart) <= 1e-6
    assert _worst(res, ~apart) <= 1e-5
    assert (w[:, 1:] >= w[:, :-1]).all()
    assert int(sweeps.max()) <= 8


def check_k2(H, R, sweeps):
    """chip_smoke.py's check_k2 gates on the model's result: against the
    plain version in float64, R within 1e-5 where sigma2 > 1e-6 sigma1,
    det R = 1 within 1e-5; against it in float32, R within 1e-5 where
    r = (sigma2 + sigma3) / sigma1 > 1e-2 and |dR| r within 1e-6 where
    sigma2 > 1e-6 sigma1; at most 10 sweeps."""
    R64 = kabsch3_plain(H.double())
    R32 = kabsch3_plain(H)
    s = torch.linalg.svdvals(H.double())
    ok = s[:, 1] > 1e-6 * s[:, 0]
    r = (s[:, 1] + s[:, 2]) / (s[:, 0] + 1e-300)
    e64 = (R.double() - R64).abs().amax(dim=(1, 2))
    e32 = (R - R32).double().abs().amax(dim=(1, 2))
    assert R.dtype == torch.float32
    assert _worst(e64, ok) <= 1e-5
    assert float((torch.linalg.det(R.double()) - 1).abs().max()) <= 1e-5
    assert _worst(e32, r > 1e-2) <= 1e-5
    assert _worst(e32 * r, ok) <= 1e-6
    assert int(sweeps.max()) <= 10
    return int(ok.sum())


def check_k2_pnp(H, R):
    """chip_smoke.py's check_k2_pnp gates on the model's result: against
    the plain version in float64, R within 1e-5 where the nearest
    rotation is determined ((sigma2 + sigma3) / sigma1 > 1e-6, and
    (sigma2 - sigma3) / sigma1 > 1e-6 too where det H < 0; sigma3 /
    sigma1 > 1e-9); everywhere the Kabsch objective tr(R H) within 1e-6
    (sigma1 + sigma2 + sigma3) of the plain version's, det R = 1 and
    R^T R = I within 1e-5. Returns the count determined."""
    R, Hd = R.double(), H.double()
    R64 = kabsch3_plain(Hd)
    s = torch.linalg.svdvals(Hd)
    top = s[:, 0] + 1e-300
    gap = torch.where(torch.linalg.det(Hd) < 0,
                      torch.minimum(s[:, 1] + s[:, 2], s[:, 1] - s[:, 2]),
                      s[:, 1] + s[:, 2]) / top
    fixed = (gap > 1e-6) & (s[:, 2] / top > 1e-9)
    dR = (R - R64).abs().amax(dim=(1, 2))
    obj = ((R * Hd.mT).sum((1, 2)) - (R64 * Hd.mT).sum((1, 2))).abs() \
        / (s.sum(1) + 1e-300)
    assert _worst(dR, fixed) <= 1e-5
    assert float(obj.max()) <= 1e-6
    assert float((torch.linalg.det(R) - 1).abs().max()) <= 1e-5
    assert float((R.mT @ R - torch.eye(3, dtype=F64)).abs().max()) <= 1e-5
    return int(fixed.sum())


def test_round_robin_covers_each_pair_once_a_sweep():
    rounds = round_robin()
    assert len(rounds) == 9
    seen = []
    for R, pairs in enumerate(rounds):
        rows = [i for pair in pairs for i in pair]
        assert len(pairs) == 4 and len(set(rows)) == 8 and R not in rows
        for p, q in pairs:                    # the kernel's partner rule
            assert (2 * R - p) % 9 == q and (2 * R - q) % 9 == p
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(9) for q in range(p + 1, 9)]


def test_rotation_diagonalises_and_matches_sym_schur2():
    rng = np.random.default_rng(3)
    app, aqq = (torch.from_numpy(rng.normal(size=64)) for _ in range(2))
    apq = torch.from_numpy(rng.normal(size=64) * 10.0 ** rng.uniform(
        -12, 2, 64))
    c, s, ta = rotation(app, aqq, apq)
    eps = 2.0 ** -52
    assert float((c * c + s * s - 1).abs().max()) <= 4 * eps   # ulps of 1
    B = torch.stack([torch.stack([app, apq], 1), torch.stack([apq, aqq], 1)],
                    1)
    J = torch.stack([torch.stack([c, s], 1), torch.stack([-s, c], 1)], 1)
    D = J.mT @ B @ J
    scale = B.abs().amax((1, 2))
    assert float((D[:, 0, 1].abs() / scale).max()) <= 1e-15
    assert float(((D[:, 0, 0] - (app - ta)).abs() / scale).max()) <= 1e-15
    assert float(((D[:, 1, 1] - (aqq + ta)).abs() / scale).max()) <= 1e-15
    # Golub and Van Loan's t = sgn(tau) / (|tau| + sqrt(1 + tau^2))
    tau = (aqq - app) / (2 * apq)
    t = torch.where(tau >= 0, 1.0, -1.0) / (tau.abs()
                                             + torch.sqrt(1 + tau * tau))
    assert torch.allclose(s / c, t, rtol=1e-14, atol=0)
    assert torch.allclose(ta, t * apq, rtol=1e-14, atol=0)
    # an a_pq whose square underflows DBL_MIN rotates nothing
    c, s, ta = rotation(*(torch.tensor([x], dtype=F64)
                          for x in (1.0, 1.0, 1e-160)))
    assert (float(c), float(s), float(ta)) == (1.0, 0.0, 0.0)


class _Recorded(Exception):
    """Ends a solve once its homography seed is recorded."""


@pytest.fixture(scope="module")
def sqpnp_inputs():
    """What SQPnP's CPU path hands K3's and K2's wrappers, with the card's
    DLT null vector (the Gram's smallest eigenvector), for 3 non-coplanar
    problems, 3 coplanar ones and the tag bundle's coplanar 3-tag layout:
    {"eig9": float32 Omegas and float64 Grams (N,9,9), "kabsch3": per
    solve the (6,3,3) and (1,3,3) float32 transposes of the Omega seeds
    (each second one sign-flipped) and of the homography seed, as
    ``_nearest_rotation_k2`` hands them to K2}. Each solve stops once its
    homography seed is recorded (the LM polish that follows needs
    none)."""
    seen = {"eig9": [], "kabsch3": []}
    saved = TP.eig9, TP._dlt_null_vector, TP._nearest_rotation

    def record9(A):
        seen["eig9"].append(A.clone())
        return eig9_plain(A)

    def record2(M):
        seen["kabsch3"].append(M.mT.reshape(-1, 3, 3).to(torch.float32))
        if len(seen["kabsch3"]) % 2 == 0:
            raise _Recorded
        return saved[2](M)

    def solve(fn, *args):
        try:
            fn(*args)
        except _Recorded:
            return
        raise AssertionError(f"{fn.__name__} formed no homography seed")

    TP.eig9, TP._dlt_null_vector, TP._nearest_rotation = \
        record9, TP._gram_null_vector, record2
    try:
        rng = np.random.default_rng(21)
        for kind in ("general", "general", "general", "coplanar",
                     "coplanar", "coplanar"):
            obj, img = _sqpnp_case(kind, rng)[:2]
            solve(TP.solve_pnp_sqpnp, _t(obj), _t(img), _t(K), _t(DIST))
        corners, cpx, valid, centers, _, _ = _bundle_case(1, 0.2)
        solve(TB.solve_tag_bundle, _t(corners), _t(cpx), _t(valid),
              _t(centers), TAG, _t(K))
    finally:
        TP.eig9, TP._dlt_null_vector, TP._nearest_rotation = saved
    return seen


@pytest.fixture(scope="module")
def sqpnp_matrices(sqpnp_inputs):
    """The (N,9,9) matrices of ``sqpnp_inputs``, by type: the float32
    Omegas and the float64 Grams."""
    return {dt: torch.cat([A for A in sqpnp_inputs["eig9"]
                           if A.dtype == dt])
            for dt in (torch.float32, F64)}


@pytest.mark.parametrize("dtype", [torch.float32, F64],
                         ids=["omega_f32", "dlt_gram_f64"])
def test_eig9_model_on_sqpnp_matrices(sqpnp_matrices, dtype):
    A = sqpnp_matrices[dtype]
    assert A.shape == (7, 9, 9)
    w, V, sweeps = eig9_model(A)
    assert check_k3(A, w, V, sweeps) >= 30
    assert 3 <= int(sweeps.min()) and int(sweeps.max()) <= 10


@pytest.mark.parametrize("n,dtype", [(5, torch.float32), (64, torch.float32),
                                     (64, F64)])
def test_eig9_model_on_clustered_spectra(n, dtype):
    A = _symmetric9(n, seed=n).to(dtype)
    w, V, sweeps = eig9_model(A)
    check_k3(A, w, V, sweeps)
    assert torch.equal(w[3], torch.zeros(9, dtype=dtype))    # zero matrix
    assert int(sweeps[3]) == int(sweeps[4]) == 0             # and identity
    assert torch.equal(V[4], torch.eye(9, dtype=dtype))
    assert torch.equal(w[4], torch.ones(9, dtype=dtype))


def test_eig9_model_is_scale_free():
    A = _symmetric9(8, seed=2)
    w, V, sweeps = eig9_model(A)
    for k in (-700, -20, 20, 500):               # 2^k: exact scalings
        ws, Vs, ss = eig9_model(A * 2.0 ** k)
        assert torch.equal(ws, w * 2.0 ** k) and torch.equal(Vs, V)
        assert torch.equal(ss, sweeps)


@pytest.mark.parametrize("n", [8, 4096])
def test_eig3_model_on_covariances(n):
    A = _covariances(n, seed=n)
    A[2] = 0.0
    A[3] = torch.eye(3)
    w, V, sweeps = eig3_model(A)
    check_k1(A, w, V, sweeps)
    assert torch.equal(w[0], torch.full((3,), 2.0))           # 2 I
    for i in (1, 2):                                          # zeros
        assert torch.equal(w[i], torch.zeros(3))
        assert torch.equal(V[i], torch.eye(3))
    assert torch.equal(V[3], torch.eye(3)) and int(sweeps[3]) == 0
    assert 2 <= int(sweeps[4:].min()) and int(sweeps.max()) <= 6


def test_kabsch3_model_on_point_triples():
    """One RANSAC draw's 8,192 triples: collinear ones, repeated picks,
    one point three times and H = 0 among them."""
    H = _kabsch_triples(8192)
    R, sweeps = kabsch3_model(H)
    assert 4000 < check_k2(H, R, sweeps) < 8192
    assert torch.equal(R[4], torch.eye(3))                    # H = 0
    assert int(sweeps[4]) == 0
    s = torch.linalg.svdvals(H.double())
    ok = s[:, 1] > 1e-6 * s[:, 0]
    # rank 2: 2-5 sweeps; the rank-1 noise of a point taken three times
    # may rotate to the cap
    assert 2 <= int(sweeps[ok].min()) and int(sweeps[ok].max()) <= 5


def test_kabsch3_model_on_collinear_triples():
    """sigma2 is noise: u2 any unit normal to u1, the Kabsch objective
    still the plain version's."""
    g = torch.Generator().manual_seed(5)
    P = torch.randn(64, 3, 3, generator=g, dtype=F64)
    P[:, 2] = P[:, 0] + torch.rand(64, 1, generator=g, dtype=F64) * (
        P[:, 1] - P[:, 0])
    Q = torch.randn(64, 3, 3, generator=g, dtype=F64)
    H = ((P - P.mean(1, keepdim=True)).mT
         @ (Q - Q.mean(1, keepdim=True))).float()
    R, sweeps = kabsch3_model(H)
    s = torch.linalg.svdvals(H.double())
    assert bool((s[:, 1] <= 1e-6 * s[:, 0]).all())
    check_k2_pnp(H, R)
    assert int(sweeps.max()) <= 10


@pytest.mark.parametrize("case", ["general", "coplanar", "bundle"])
def test_kabsch3_model_on_sqpnp_seeds(sqpnp_inputs, case):
    """The seeds SQPnP projects to SO(3) (tests/test_torch_sqpnp.py's
    cases): per solve six Omega seeds, each second one the negative of
    the one before (-R/sqrt(3) where Omega's null vector is exact: sigma2
    = sigma3 and det < 0, a free axis), then one homography seed."""
    seen = sqpnp_inputs["kabsch3"]
    assert len(seen) == 14
    first = {"general": 0, "coplanar": 3, "bundle": 6}[case]
    solves = range(first, 7 if case == "bundle" else first + 3)
    H = torch.cat([seen[2 * i + k] for i in solves for k in (0, 1)])
    assert H.dtype == torch.float32 and H.shape[1:] == (3, 3)
    assert all(seen[2 * i].shape[0] == 6 and seen[2 * i + 1].shape[0] == 1
               for i in solves)
    assert all(torch.equal(seen[2 * i][1::2], -seen[2 * i][::2])
               for i in solves)
    R, sweeps = kabsch3_model(H)
    fixed = check_k2_pnp(H, R)
    # non-coplanar: every seed determined; coplanar (a rank-deficient
    # Omega): at least each homography seed
    assert fixed == len(H) if case == "general" else fixed >= len(solves)
    assert int(sweeps.max()) <= 10

