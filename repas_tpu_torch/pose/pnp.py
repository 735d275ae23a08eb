"""PnP solvers: IPPE-square, the detector's homography pose, SQPnP and
the Levenberg-Marquardt polish.

Port of ``repas_tpu/pose/pnp.py`` (``square_object_points``,
``_homography_4pt``, ``_svd2x2_signed``, ``_rotation_e3_to``,
``_ippe_from_homography``, ``solve_pnp_ippe_square``, ``detector_pose``,
``_chol_solve6``, ``_residuals``, ``refine_pnp_gn``,
``_nearest_rotation``, ``_rotation_from_homography``,
``solve_pnp_sqpnp``, ``SQUARE_ORDERS``, ``solve_pnp_best_order``). Every
function broadcasts over leading dimensions: the frame pipeline solves
(B, D, 2 branches) problems in one pass. The LM Jacobian is forward mode
(``torch.autograd.forward_ad`` with the six basis tangents batched), as
the reference takes it from ``jax.linearize``.

The reference's jitted solvers are compiled steps (``core.jit``) beside
their plain functions, which stay plain so that an eager caller (the
eager ``process_frames``) captures no graph of its own:
``solve_pnp_ippe_square_jit``, ``refine_pnp_gn_jit``,
``solve_pnp_sqpnp_jit`` and ``solve_pnp_best_order_jit``;
``detector_pose`` is compiled as its public function. ``K`` and ``dist``
may be numpy arrays there (copied to the step's device first).

``dist=None`` statically skips the Brown-Conrady polynomial in every
projection (the frame pipeline's default); a coefficient vector (a
tensor on the inputs' device: a host array would be copied, blocking)
undistorts the corners and distorts every projection of the LM loop.

IPPE: with object plane z=0 and the normalized-coords homography H, the
plane origin projects to v = (H13,H23)/H33 and the map's Jacobian there
is J = (1/t_z) P R[:,:2]; writing R = R_v Q with R_v e3 = [v;1]/s gives
B^{-1} J = (1/t_z) Q[:2,:2], whose singular values (1, |q33|) yield t_z
and the two planar-ambiguity completions of Q.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from repas_tpu_torch.core.consts import const
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.core.transforms import (homography_from_unit_square,
                                             rodrigues, rodrigues_inv, skew)
from repas_tpu_torch.kernels.eig9 import eig9
from repas_tpu_torch.kernels.kabsch3 import kabsch3
from repas_tpu_torch.kernels.project import project_points, undistort_points

_EPS = 1e-12

# The 8 cyclic + reflected corner orderings, as permutations of
# [TL,TR,BR,BL] (the reference's solve_pnp_best_order)
SQUARE_ORDERS = np.array([
    [0, 1, 2, 3],
    [1, 2, 3, 0],
    [2, 3, 0, 1],
    [3, 0, 1, 2],
    [1, 0, 3, 2],
    [0, 3, 2, 1],
    [3, 2, 1, 0],
    [2, 1, 0, 3],
], dtype=np.int32)


def square_object_points(tag_size_m: float, device) -> torch.Tensor:
    """Canonical TL,TR,BR,BL square corners (4,3) f32 in the tag plane z=0
    (half-size = float32(tag_size_m) / 2, as the reference rounds it)."""
    h = float(np.float32(tag_size_m)) / 2.0
    return const(((-h, -h, 0.0), (h, -h, 0.0), (h, h, 0.0), (-h, h, 0.0)),
                 torch.float32, device)


def _dist(dist, like: torch.Tensor):
    """Coefficients as a tensor of `like`'s dtype and device, or None."""
    return None if dist is None else torch.as_tensor(
        dist, dtype=like.dtype, device=like.device)


def _homography_4pt(obj_xy: torch.Tensor, img_xy: torch.Tensor
                    ) -> torch.Tensor:
    """Exact homographies (...,3,3), H33 = 1, from 4 correspondences
    (...,4,2) by an 8x8 solve."""
    x, y, u, w = torch.broadcast_tensors(obj_xy[..., 0], obj_xy[..., 1],
                                         img_xy[..., 0], img_xy[..., 1])
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -w * x, -w * y], -1)
    A = torch.cat([rows_u, rows_v], dim=-2)                # (...,8,8)
    h = torch.linalg.solve(A, torch.cat([u, w], dim=-1))
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(
        *h.shape[:-1], 3, 3)


def _rot2(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def _svd2x2_signed(A: torch.Tensor):
    """Proper 2x2 SVD A = U diag(s1, s2) V^T with U,V rotations;
    s1 >= |s2|, sign(s2) = sign(det A). A (...,2,2)."""
    E = (A[..., 0, 0] + A[..., 1, 1]) / 2.0
    F = (A[..., 0, 0] - A[..., 1, 1]) / 2.0
    G = (A[..., 1, 0] + A[..., 0, 1]) / 2.0
    H = (A[..., 1, 0] - A[..., 0, 1]) / 2.0
    Q = torch.sqrt(E * E + H * H)
    Rm = torch.sqrt(F * F + G * G)
    a1 = torch.atan2(G, F)    # = phi + theta
    a2 = torch.atan2(H, E)    # = phi - theta
    theta = (a1 - a2) / 2.0   # V angle
    phi = (a1 + a2) / 2.0     # U angle
    return _rot2(phi), torch.stack([Q + Rm, Q - Rm], dim=-1), _rot2(theta)


def _rotation_e3_to(t_hat: torch.Tensor) -> torch.Tensor:
    """Rotation (...,3,3) taking e3 to the unit vectors t_hat (...,3)."""
    c = t_hat[..., 2]
    axis = torch.stack([-t_hat[..., 1], t_hat[..., 0], torch.zeros_like(c)],
                       dim=-1)
    s = torch.linalg.vector_norm(axis, dim=-1)
    k = axis / torch.clamp(s, min=_EPS)[..., None]
    K = skew(k)
    eye = torch.eye(3, dtype=t_hat.dtype, device=t_hat.device)
    # K is skew of the UNIT axis; s = sin(angle), c = cos(angle)
    R = eye + s[..., None, None] * K + (1.0 - c)[..., None, None] * (K @ K)
    return torch.where((s < 1e-8)[..., None, None], eye, R)


def _ippe_from_homography(Hn: torch.Tensor):
    """Both IPPE pose solutions from normalized-coords homographies
    (...,3,3) of the unit half-size square: (R (...,2,3,3), t (...,2,3))."""
    h22 = Hn[..., 2, 2]
    v = torch.stack([Hn[..., 0, 2], Hn[..., 1, 2]], dim=-1) / h22[..., None]
    J = (Hn[..., :2, :2] - v[..., :, None] * Hn[..., 2, None, :2]) \
        / h22[..., None, None]
    s = torch.sqrt(1.0 + torch.sum(v * v, dim=-1))
    one = torch.ones_like(v[..., :1])
    t_hat = torch.cat([v, one], dim=-1) / s[..., None]
    Rv = _rotation_e3_to(t_hat)
    B = Rv[..., :2, :2] - v[..., :, None] * Rv[..., 2, None, :2]
    detB = B[..., 0, 0] * B[..., 1, 1] - B[..., 0, 1] * B[..., 1, 0]
    detB = torch.where(torch.abs(detB) < _EPS, _EPS, detB)
    Binv = torch.stack([
        torch.stack([B[..., 1, 1], -B[..., 0, 1]], dim=-1),
        torch.stack([-B[..., 1, 0], B[..., 0, 0]], dim=-1)],
        dim=-2) / detB[..., None, None]
    A = Binv @ J
    U, sig, V = _svd2x2_signed(A)
    tz = 1.0 / torch.clamp(sig[..., 0], min=_EPS)
    cb = torch.clamp(sig[..., 1] * tz, -1.0, 1.0)     # q33 = cos(beta)
    sb = torch.sqrt(torch.clamp(1.0 - cb * cb, min=0.0))
    zero, ones = torch.zeros_like(cb), torch.ones_like(cb)
    # 2x2 -> 3x3 with a 1 at (2,2); an indexed assignment of 1.0 would
    # copy a host scalar into a 0-dim view, blocking, for unbatched input
    e33 = const(((False,) * 3, (False,) * 3, (False, False, True)),
                torch.bool, A.device)
    Uf = torch.where(e33, 1.0, F.pad(U, (0, 1, 0, 1)))
    Vf = torch.where(e33, 1.0, F.pad(V, (0, 1, 0, 1)))
    t = tz[..., None] * torch.cat([v, one], dim=-1)
    Rs = []
    for sgn in (1.0, -1.0):
        Rx = torch.stack([
            torch.stack([ones, zero, zero], dim=-1),
            torch.stack([zero, cb, -sgn * sb], dim=-1),
            torch.stack([zero, sgn * sb, cb], dim=-1)], dim=-2)
        Rs.append(Rv @ (Uf @ Rx @ Vf.transpose(-1, -2)))
    return torch.stack(Rs, dim=-3), torch.stack([t, t], dim=-2)


def solve_pnp_ippe_square(img_corners: torch.Tensor, K: torch.Tensor,
                          tag_size_m: float, refine_iters: int = 8,
                          dist=None):
    """IPPE_SQUARE: pixel corners (...,4,2) in TL,TR,BR,BL object order
    -> (R (...,3,3), t (...,3), reproj_err_px (...)).

    Both analytic solutions are LM-polished and the lower-reprojection
    one (with t_z > 0) wins. `dist=None` normalizes the corners in closed
    form; a coefficient vector undistorts them (10 fixed-point steps)."""
    K = torch.as_tensor(K, dtype=img_corners.dtype,
                        device=img_corners.device)
    dist = _dist(dist, K)
    obj = square_object_points(tag_size_m, img_corners.device).to(
        img_corners.dtype)
    if dist is None:
        norm_xy = torch.stack(
            [(img_corners[..., 0] - K[0, 2]) / K[0, 0],
             (img_corners[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)
    else:
        norm_xy = undistort_points(img_corners, K, dist)
    Hn = homography_from_unit_square(norm_xy)
    Rs, ts = _ippe_from_homography(Hn)
    ts = ts * (tag_size_m / 2.0)
    # polish BOTH analytic branches and pick by refined reprojection
    # error: under corner noise their pre-refine errors overlap
    img2 = img_corners[..., None, :, :].expand(*Rs.shape[:-2], 4, 2)
    rvs, ts2, errs = refine_pnp_gn(obj, img2, rodrigues_inv(Rs), ts, K,
                                   dist, iters=refine_iters)
    scores = errs + torch.where(ts2[..., 2] <= 0, 1e6, 0.0)
    best = torch.argmin(scores, dim=-1)[..., None]
    rv = torch.take_along_dim(rvs, best[..., None], dim=-2)[..., 0, :]
    t = torch.take_along_dim(ts2, best[..., None], dim=-2)[..., 0, :]
    err = torch.take_along_dim(errs, best, dim=-1)[..., 0]
    return rodrigues(rv), t, err


@functools.partial(jit, static_argnames=("tag_size_m",))
def detector_pose(img_corners: torch.Tensor, K: torch.Tensor,
                  tag_size_m: float):
    """The AprilTag library's homography pose: both IPPE branches of the
    corners' homography, no distortion model and no polish, the branch
    with t_z > 0 and the lower reprojection error winning. Corners
    (...,4,2) -> (R (...,3,3), t (...,3), err_px (...)).

    A compiled step (``core.jit``). ``tag_size_m``, which the reference
    traces, is static here, as in ``TagTracker._ippe``: it keys the
    object points' cached constant (ROADMAP C)."""
    K = K.to(img_corners.dtype)
    obj = square_object_points(tag_size_m, img_corners.device).to(
        img_corners.dtype)
    zeros = const((0.0,) * 8, img_corners.dtype, img_corners.device)
    Hn = homography_from_unit_square(undistort_points(img_corners, K, zeros))
    Rs, ts = _ippe_from_homography(Hn)
    ts = ts * (tag_size_m / 2.0)
    proj = project_points(obj, rodrigues_inv(Rs), ts, K)      # (...,2,4,2)
    errs = torch.mean(torch.linalg.vector_norm(
        proj - img_corners[..., None, :, :], dim=-1), dim=-1)
    scores = errs + torch.where(ts[..., 2] <= 0, 1e6, 0.0)
    best = torch.argmin(scores, dim=-1)[..., None]
    R = torch.take_along_dim(Rs, best[..., None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None], dim=-2)[..., 0, :]
    err = torch.take_along_dim(errs, best, dim=-1)[..., 0]
    return R, t, err


def _chol_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems A X = B (A (...,n,n), B (...,n,M)) by fully
    unrolled pivot-free Cholesky in plain tensor operations, one path on
    every device (``torch.linalg.solve`` on the card reads a status on
    the host). A zero matrix yields a huge but finite solution."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for k in range(i + 1):
            s = A[..., i, k]
            for m in range(k):
                s = s - L[i][m] * L[k][m]
            if i == k:
                L[i][k] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][k] = s / L[k][k]
    L = [[None if v is None else v[..., None] for v in r] for r in L]
    y = []
    for i in range(n):
        s = B[..., i, :]
        for m in range(i):
            s = s - L[i][m] * y[m]
        y.append(s / L[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for m in range(i + 1, n):
            s = s - L[m][i] * x[m]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-2)


def _chol_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems A x = b (A (...,6,6), b (...,6)) by
    ``_chol_solve``, in the reference's operation order. A zero matrix
    yields a huge but finite step that the LM accept test rejects."""
    return _chol_solve(A, b[..., None])[..., 0]


def _residuals(params, obj, img, K, dist, w):
    """Weighted reprojection residuals (...,2N) of params (...,6)
    [rvec, t] for object points (...,N,3), pixels (...,N,2) and weights
    (...,N)."""
    proj = project_points(obj, params[..., :3], params[..., 3:], K, dist)
    return ((proj - img) * w[..., None]).flatten(-2)


def _jacobian(fn, p: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian (...,M,6) of fn (...,6) -> (...,M) at p: the
    six basis tangents ride in one extra leading batch dimension, so all
    problems and all directions go through fn once."""
    tangents = torch.eye(6, dtype=p.dtype, device=p.device).reshape(
        6, *([1] * (p.ndim - 1)), 6).expand(6, *p.shape).contiguous()
    # torch.inference_mode() turns forward AD off; the duals are made
    # outside it
    with torch.inference_mode(False), fwAD.dual_level():
        dual = fwAD.make_dual(p.expand(6, *p.shape).contiguous(), tangents)
        J = fwAD.unpack_dual(fn(dual)).tangent           # (6,...,M)
    return torch.movedim(J, 0, -1)


def refine_pnp_gn(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                  rvec0: torch.Tensor, tvec0: torch.Tensor, K: torch.Tensor,
                  dist=None, iters: int = 10, damping: float = 1e-6,
                  weights=None):
    """Adaptive Levenberg-Marquardt on reprojection error over (rvec, t).

    obj_pts (N,3) shared or (...,N,3); img_pts (...,N,2), rvec0/tvec0
    (...,3). `weights` (N,) or (...,N) scales per-point residuals (0
    masks a point out). Returns (rvec (...,3), tvec (...,3),
    mean_reproj_err_px over weighted points (...)). Lambda shrinks on an
    accepted step and grows on a rejected one; a fixed iteration count,
    no early exit.
    """
    dt = img_pts.dtype
    K = torch.as_tensor(K, dtype=dt, device=img_pts.device)
    dist = _dist(dist, K)
    n = obj_pts.shape[-2]
    w = (torch.ones(n, dtype=dt, device=img_pts.device) if weights is None
         else torch.as_tensor(weights, dtype=dt, device=img_pts.device))
    p = torch.cat([rvec0.to(dt), tvec0.to(dt)], dim=-1)

    def res_fn(pp):
        return _residuals(pp, obj_pts, img_pts, K, dist, w)

    eye6 = torch.eye(6, dtype=dt, device=p.device)
    r = res_fn(p)
    cost = torch.sum(r * r, dim=-1)
    # damping may be a 0-d tensor (the compiled step's scalar)
    lam = torch.zeros(p.shape[:-1], dtype=dt, device=p.device) + damping
    for _ in range(iters):
        Jm = _jacobian(res_fn, p)
        JT = Jm.transpose(-1, -2)
        JTJ = JT @ Jm
        JTr = (JT @ r[..., None])[..., 0]
        mu = lam * torch.diagonal(JTJ, dim1=-2, dim2=-1).sum(-1) / 6.0
        step = _chol_solve6(JTJ + mu[..., None, None] * eye6, JTr)
        p_new = p - step
        r_new = res_fn(p_new)
        cost_new = torch.sum(r_new * r_new, dim=-1)
        better = cost_new < cost
        p = torch.where(better[..., None], p_new, p)
        r = torch.where(better[..., None], r_new, r)
        cost = torch.where(better, cost_new, cost)
        lam = torch.where(better, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(torch.clamp(lam * 8.0, min=1e-4),
                                      max=1e6))
    proj = project_points(obj_pts, p[..., :3], p[..., 3:], K, dist)
    per_pt = torch.linalg.vector_norm(proj - img_pts, dim=-1)
    wpos = (w > 0).to(dt)
    err = torch.sum(per_pt * wpos, dim=-1) / torch.clamp(wpos.sum(-1), min=1)
    return p[..., :3], p[..., 3:], err


def _nearest_rotation(M: torch.Tensor) -> torch.Tensor:
    """Project (...,3,3) matrices to SO(3) via SVD (det-corrected); on the
    card through kernel K2 (``_nearest_rotation_k2``)."""
    if M.is_cuda:
        return _nearest_rotation_k2(M)
    U, _, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (U * D[..., None, :]) @ Vt


def _nearest_rotation_k2(M: torch.Tensor) -> torch.Tensor:
    """M's nearest rotations through kernel K2's wrapper, in float32:
    kabsch3(M^T) = V diag(1, 1, d) U^T for M^T = U S V^T, with
    d = sign det(V U^T). K2 takes float32 only, so a float64 M is rounded
    to float32 first and the rotation returned in float64: on the card a
    float64 SQPnP call projects its seeds in float32 (the seeds are then
    LM-polished in float64), where the CPU's SVD keeps float64."""
    R = kabsch3(M.mT.reshape(-1, 3, 3).to(torch.float32).contiguous())
    return R.reshape(M.shape).to(M.dtype)


def _rotation_from_homography(Hm: torch.Tensor) -> torch.Tensor:
    """SO(3) seed (...,3,3) from plane-to-normalized-image homographies
    H ~ s [r1 r2 t] of either sign: h1 and h2 are flipped so the plane
    origin sits at positive depth before the cross product (negating the
    whole matrix would flip the third column too)."""
    h1, h2, h3 = Hm[..., :, 0], Hm[..., :, 1], Hm[..., :, 2]
    s = 0.5 * (torch.linalg.vector_norm(h1, dim=-1)
               + torch.linalg.vector_norm(h2, dim=-1))
    sgn = torch.where(h3[..., 2] < 0, -1.0, 1.0)[..., None]
    h3n = torch.linalg.cross(h1, h2, dim=-1) / torch.clamp(
        s, min=1e-20)[..., None]
    return _nearest_rotation(torch.stack([sgn * h1, sgn * h2, h3n], dim=-1))


def _eigh9(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of symmetric (...,9,9) matrices through
    kernel K3's wrapper (K3 on the card, LAPACK on the CPU)."""
    w, V = eig9(M.reshape(-1, 9, 9))
    return w.reshape(M.shape[:-1]), V.reshape(M.shape)


def _dlt_null_vector(Ah: torch.Tensor) -> torch.Tensor:
    """The unit null vectors (...,9), of either sign, of the DLT rows Ah
    (...,2N,9): on the card ``_gram_null_vector``, on the CPU the SVD's
    last right singular vector."""
    if Ah.is_cuda:
        return _gram_null_vector(Ah)
    return torch.linalg.svd(Ah, full_matrices=False)[2][..., -1, :]


def _gram_null_vector(Ah: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue of the Gram matrix
    Ah^T Ah, formed in float64 (kernel K3's float64 entry on the card)."""
    Ad = Ah.to(torch.float64)
    return _eigh9(Ad.mT @ Ad)[1][..., :, 0].to(Ah.dtype)


def solve_pnp_sqpnp(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                    K: torch.Tensor, dist=None, refine_iters: int = 15,
                    weights=None):
    """General PnP: object points (N,3) or (...,N,3), pixels (...,N,2),
    optional weights (N,) or (...,N) -> (R (...,3,3), t (...,3),
    mean_reproj_err_px (...)).

    Minimizes sum_i ||(I - u_i u_i^T)(R p_i + t)||^2 over bearing rays
    u_i; eliminating t (t = T vec(R)) leaves x^T Omega x over
    x = vec(R). Seeds: the three smallest eigenvectors of Omega with both
    signs, projected to SO(3), and a weighted homography DLT (exact for
    coplanar layouts, where Omega's small eigen-subspace is degenerate).
    Each seed is LM-polished on reprojection error with the distortion
    polynomial (zeros when `dist` is None); the lowest error with every
    weighted point in front of the camera wins.

    Nothing reads a status on the host, so the call captures as a CUDA
    graph (``solve_pnp_sqpnp_jit``): the 3x3 solve for t is an unrolled
    Cholesky on every device; on the card Omega's eigenvectors come from
    kernel K3, the DLT's null vector is K3's eigenvector of the smallest
    eigenvalue of the DLT's Gram matrix (formed in float64; its sign is
    free, and ``_rotation_from_homography`` takes either), and the
    projections to SO(3) are kernel K2 (in float32, whatever the input's
    type). On the CPU they are LAPACK's eigh, the DLT's SVD and the SVD
    projection."""
    dt = img_pts.dtype
    dev = img_pts.device
    K = torch.as_tensor(K, dtype=dt, device=dev)
    dist = (const((0.0,) * 8, dt, dev) if dist is None
            else _dist(dist, K))
    obj = obj_pts.to(dt)
    n = obj.shape[-2]
    wts = (torch.ones(n, dtype=dt, device=dev) if weights is None
           else torch.as_tensor(weights, dtype=dt, device=dev))
    xy = undistort_points(img_pts, K, dist)                   # (...,N,2)
    u = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    W = (eye3 - u[..., :, None] * u[..., None, :]) * wts[..., None, None]

    # A_i x = R p_i with x = vec(R) (row-major): A_i = kron(I3, p_i^T)
    A = torch.einsum("ab,...nc->...nabc", eye3, obj).reshape(
        *obj.shape[:-1], 3, 9)
    SW = W.sum(dim=-3)                                        # (...,3,3)
    SWA = torch.einsum("...nij,...njk->...ik", W, A)          # (...,3,9)
    T = -_chol_solve(SW + _EPS * eye3, SWA)                   # t = T x
    M = A + T[..., None, :, :]
    Omega = torch.einsum("...nia,...nij,...njb->...ab", M, W, M)

    _, evecs = _eigh9(Omega)
    small = evecs[..., :, :3].transpose(-1, -2)               # (...,3,9)
    seeds = torch.stack([small, -small], dim=-2).reshape(
        *small.shape[:-2], 6, 3, 3)
    cand = [_nearest_rotation(seeds)]

    # weighted homography DLT on (x, y) -> normalized coords
    sw = torch.sqrt(torch.clamp(wts, min=0.0))[..., None]
    x_, y_, uu, vv = torch.broadcast_tensors(obj[..., 0], obj[..., 1],
                                             xy[..., 0], xy[..., 1])
    one, zero = torch.ones_like(x_), torch.zeros_like(x_)
    r_u = torch.stack([x_, y_, one, zero, zero, zero,
                       -uu * x_, -uu * y_, -uu], dim=-1)
    r_v = torch.stack([zero, zero, zero, x_, y_, one,
                       -vv * x_, -vv * y_, -vv], dim=-1)
    Ah = torch.cat([r_u * sw, r_v * sw], dim=-2)              # (...,2N,9)
    h = _dlt_null_vector(Ah)
    Hm = h.reshape(*h.shape[:-1], 3, 3)
    cand.append(_rotation_from_homography(Hm)[..., None, :, :])
    cand_R = torch.cat(cand, dim=-3)                          # (...,7,3,3)

    # t per seed from the closed form t = T vec(R), optimal for any R
    t0 = (T[..., None, :, :] @ cand_R.flatten(-2)[..., None])[..., 0]
    obj7 = obj[..., None, :, :]
    w7 = wts[..., None, :]
    img7 = img_pts[..., None, :, :].expand(*cand_R.shape[:-2], n, 2)
    rvecs, ts, errs = refine_pnp_gn(obj7, img7, rodrigues_inv(cand_R), t0, K,
                                    dist, iters=refine_iters, weights=w7)
    cam_z = (obj7 @ rodrigues(rvecs).transpose(-1, -2)
             + ts[..., None, :])[..., 2]
    front = torch.all((cam_z > 0) | (w7 <= 0), dim=-1)
    scores = errs + torch.where(front, 0.0, 1e6)
    best = torch.argmin(scores, dim=-1)[..., None]
    rv = torch.take_along_dim(rvecs, best[..., None], dim=-2)[..., 0, :]
    t = torch.take_along_dim(ts, best[..., None], dim=-2)[..., 0, :]
    err = torch.take_along_dim(errs, best, dim=-1)[..., 0]
    return rodrigues(rv), t, err


def solve_pnp_best_order(img_corners: torch.Tensor, K: torch.Tensor,
                         tag_size_m: float, z_penalty: float = 1000.0,
                         refine_iters: int = 8, dist=None):
    """Try all 8 object-corner orderings with IPPE-square; score = mean
    reprojection error + z_penalty where t_z <= 0; keep the best.

    img_corners (...,4,2) -> (R (...,3,3), t (...,3), err_px (...),
    order_idx (...) int64). All orders of all problems go through one
    ``solve_pnp_ippe_square`` pass; ties pick the lowest order."""
    # pairing obj[order] with the corners as given = the canonical object
    # points against the corners un-permuted by order's inverse
    inv = tuple(tuple(int(i) for i in np.argsort(o)) for o in SQUARE_ORDERS)
    inv = const(inv, torch.int64, img_corners.device)         # (8,4)
    c = img_corners[..., inv, :]                              # (...,8,4,2)
    Rs, ts, errs = solve_pnp_ippe_square(c, K, tag_size_m,
                                         refine_iters=refine_iters, dist=dist)
    scores = errs + torch.where(ts[..., 2] <= 0, z_penalty, 0.0)
    best = torch.argmin(scores, dim=-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[
        ..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    err = torch.take_along_dim(errs, best[..., None], dim=-1)[..., 0]
    return R, t, err, best


# The reference's jitted solvers as compiled steps beside their plain
# functions. ``tag_size_m``, which the reference traces, is static: it keys
# the object points' cached constant (ROADMAP C, static departures).
solve_pnp_ippe_square_jit = jit(
    solve_pnp_ippe_square, static_argnames=("tag_size_m", "refine_iters"),
    array_argnames=("K", "dist"))
refine_pnp_gn_jit = jit(refine_pnp_gn, static_argnames=("iters",),
                        scalar_argnames=("damping",),
                        array_argnames=("K", "dist"))
solve_pnp_sqpnp_jit = jit(solve_pnp_sqpnp, static_argnames=("refine_iters",),
                          array_argnames=("K", "dist"))
solve_pnp_best_order_jit = jit(
    solve_pnp_best_order, static_argnames=("tag_size_m", "refine_iters"),
    scalar_argnames=("z_penalty",), array_argnames=("K", "dist"))
