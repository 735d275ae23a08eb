"""Checkerboard camera calibration.

Port of ``repas_tpu/calib/checkerboard.py`` (``_saddle_response``,
``_nms_topk``, ``detect_checkerboard_corners``, ``refine_corners_subpix``,
``_homography_dlt``, ``_zhang_init``, ``calibrate_camera``), which
replaces OpenCV's path:
  * findChessboardCornersSB + cornerSubPix -> saddle response (negative
    Hessian determinant) with an X-corner quadrant gate, non-max
    suppression and top-k, homography-guided grid ordering, then the
    gradient-orthogonality sub-pixel iteration, batched over corners;
  * calibrateCamera -> Zhang's closed-form initialisation (host, float64
    numpy, copied) and a 100-step Levenberg-Marquardt over intrinsics,
    distortion and every view's pose at once, on the device in float32
    with Jacobi scaling. The Jacobian is forward-mode (the parameters'
    basis tangents as one batch dimension), and each step solves with
    ``solve_ex``, so the loop reads nothing back until the final RMS.

The reference's jitted pieces are compiled steps here (``core.jit``: a
CUDA graph per static configuration on the card, the function itself on
the CPU): ``refine_corners_subpix`` and the LM's step (the reference's
``lax.scan`` body), which ``calibrate_camera`` replays once per
iteration. The step solves with cuSOLVER on the card, which reads no
status on the host.

Ties are broken as the reference's: ``lax.top_k`` and ``nanargmin`` keep
the lowest index, so peaks are ranked by (score descending, index
ascending) with a stable sort. The homography fits solve their least
squares in float64 (the reference: f32 ``jnp.linalg.lstsq``); H agrees
within a stated tolerance and the snapped corners, picked by argmin,
are equal (tests/test_torch_calib.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.core.precision import cusolver
from repas_tpu_torch.core.transforms import rodrigues, rodrigues_inv
from repas_tpu_torch.kernels.image import (_pad_edge, _window2d,
                                           bilinear_sample, gaussian_blur,
                                           sobel)


# ---------------------------------------------------------------------------
# corner detection
# ---------------------------------------------------------------------------

def _saddle_response(gray: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """Negative Hessian determinant: large where the image has a saddle
    (checkerboard X-corners)."""
    g = gaussian_blur(gray, sigma)
    gx, gy = sobel(g)
    gxx, gxy = sobel(gx)
    gyx, gyy = sobel(gy)
    return gxy * gyx - gxx * gyy      # -det(H) > 0 at saddles


def _nms_topk(resp: torch.Tensor, k: int, radius: int = 4):
    """Non-max suppression + top-k peak extraction of an (H,W) response.
    Returns (k,2) uv and (k,) scores, ranked by score then by flat index
    (the order of the reference's ``lax.top_k`` among ties). Of several
    maxima tied within one window only the first in raster order is a
    peak: the reference keeps them all, but XLA's rounding of the 11-tap
    blur breaks such ties where the port's does not (ROADMAP C)."""
    size = 2 * radius + 1
    mx = _window2d(resp, size, "max")
    h, w = resp.shape
    is_peak = (resp >= mx) & (resp > 0)
    # two peaks in one window tie exactly (a plateau of a pixel-aligned
    # render); keep the first in raster order (ROADMAP C)
    flat = torch.arange(h * w, dtype=torch.float32,
                        device=resp.device).reshape(h, w)
    first = _window2d(torch.where(is_peak, flat, torch.inf), size, "min")
    peaks = torch.where(is_peak & (flat == first), resp, 0.0)
    scores, idx = torch.sort(peaks.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:k], idx[:k]
    uv = torch.stack([(idx % w).to(torch.float32),
                      (idx // w).to(torch.float32)], dim=1)
    return uv, scores


def _fit_h(src_pts: torch.Tensor, dst_pts: torch.Tensor) -> torch.Tensor:
    """Homography (3,3) with H[2,2] = 1 mapping src -> dst by linear least
    squares over the 8 unknowns, solved in float64."""
    x, y = src_pts[:, 0].double(), src_pts[:, 1].double()
    u, v = dst_pts[:, 0].double(), dst_pts[:, 1].double()
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    ru = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], 1)
    rv = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], 1)
    A = torch.cat([ru, rv], 0)
    b = torch.cat([u, v], 0)
    sol = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    return torch.cat([sol, one[:1]]).reshape(3, 3).to(torch.float32)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, averaging the two middle values of an even
    count (``jnp.median``; ``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def detect_checkerboard_corners(gray: torch.Tensor, cols: int, rows: int,
                                sigma: float = 1.5):
    """Detect and grid-order the inner corners of a checkerboard in an
    (H,W) gray image.

    Returns (corners (rows*cols, 2) float32 in row-major board order,
    ok () bool). The 4 extremal detections seed a homography from board
    grid coords; each grid node snaps to its nearest detection; a second
    homography fit over all snapped nodes refines the assignment."""
    gray = gray.to(torch.float32)
    dev = gray.device
    n = rows * cols
    resp = _saddle_response(gray, sigma)
    # X-corner quadrant test: at a true corner both diagonals differ with
    # the same sign; at board-boundary L-corners one difference vanishes
    g = gaussian_blur(gray, 1.0)
    r = 3
    p = _pad_edge(g, r)
    h, w = gray.shape
    q1 = p[0:h, 0:w]                  # (-r,-r)
    q2 = p[2 * r:, 2 * r:][:h, :w]    # (+r,+r)
    q3 = p[2 * r:, 0:w][:h, :]        # (+r,-r)
    q4 = p[0:h, 2 * r:][:, :w]        # (-r,+r)
    d13 = q1 - q3
    d24 = q2 - q4
    xcorner = torch.minimum(torch.abs(d13), torch.abs(d24)) * (
        torch.sign(d13) == torch.sign(d24))
    resp = torch.where(xcorner > 10.0, resp, 0.0)
    uv, scores = _nms_topk(resp, n + n // 2)      # some headroom
    valid = scores > 0.05 * scores[0]
    uv = torch.where(valid[:, None], uv, torch.nan)

    # extremal seeds (TL, TR, BR, BL in board orientation); NaN rows never
    # win, ties go to the first index
    s = uv[:, 0] + uv[:, 1]
    d = uv[:, 0] - uv[:, 1]
    inf = torch.inf
    tl = uv[torch.argmin(torch.where(valid, s, inf))]
    br = uv[torch.argmax(torch.where(valid, s, -inf))]
    tr = uv[torch.argmax(torch.where(valid, d, -inf))]
    bl = uv[torch.argmin(torch.where(valid, d, inf))]
    quad = torch.stack([tl, tr, br, bl])

    src = torch.tensor([[0.0, 0.0], [cols - 1.0, 0.0],
                        [cols - 1.0, rows - 1.0], [0.0, rows - 1.0]],
                       device=dev)
    H = _fit_h(src, quad)

    gy_, gx_ = torch.meshgrid(torch.arange(rows, dtype=torch.float32,
                                           device=dev),
                              torch.arange(cols, dtype=torch.float32,
                                           device=dev), indexing="ij")
    grid = torch.stack([gx_.reshape(-1), gy_.reshape(-1)], 1)  # row-major
    grid_h = torch.cat([grid, torch.ones(n, 1, device=dev)], 1)

    def snap(H):
        ph = grid_h @ H.T
        pred = ph[:, :2] / ph[:, 2:3]
        d2 = torch.sum((pred[:, None, :] - uv[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(torch.isnan(d2), inf, d2)
        j = torch.argmin(d2, dim=1)
        return uv[j], torch.gather(d2, 1, j[:, None])[:, 0]

    snapped, d2 = snap(H)
    # refit with all snapped points, snap again
    snapped, d2 = snap(_fit_h(grid, snapped))

    # sanity: every node found a nearby unique corner
    dist = torch.sqrt(d2)
    ok = torch.all(dist < torch.clamp(4.0 * _median(dist), min=3.0))
    return snapped, ok


@functools.partial(jit, static_argnames=("win", "iters"))
def refine_corners_subpix(gray: torch.Tensor, corners: torch.Tensor,
                          win: int = 5, iters: int = 20):
    """cornerSubPix equivalent, batched over corners (C,2): iterates
    q <- solve(sum w g g^T, sum w g g^T p) over a (2win+1)^2 window of
    gradients g (the orthogonality condition), each step clamped to
    +-2 px, a fixed number of times."""
    gray = gray.to(torch.float32)
    gx, gy = sobel(gray)
    r = win
    dev = gray.device
    a = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(a, a, indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)      # (M,2)
    # Gaussian-ish window weights
    wgt = torch.exp(-0.5 * torch.sum((offs / (r * 0.6)) ** 2, dim=1))
    q = corners.to(torch.float32)
    for _ in range(iters):
        p = q[:, None, :] + offs                                   # (C,M,2)
        Ix = bilinear_sample(gx, p)
        Iy = bilinear_sample(gy, p)
        a_ = torch.sum(wgt * Ix * Ix, dim=1)
        b_ = torch.sum(wgt * Ix * Iy, dim=1)
        c_ = torch.sum(wgt * Iy * Iy, dim=1)
        bx = torch.sum(wgt * (Ix * Ix * p[..., 0] + Ix * Iy * p[..., 1]),
                       dim=1)
        by = torch.sum(wgt * (Ix * Iy * p[..., 0] + Iy * Iy * p[..., 1]),
                       dim=1)
        det = a_ * c_ - b_ * b_
        det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
        q_new = torch.stack([(c_ * bx - b_ * by) / det,
                             (a_ * by - b_ * bx) / det], dim=-1)
        # clamp runaway steps
        q = q + torch.clamp(q_new - q, -2.0, 2.0)
    return q


# ---------------------------------------------------------------------------
# Zhang init + batched LM
# ---------------------------------------------------------------------------

def _homography_dlt(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Normalized DLT homography (host-side, per view, float64)."""
    def norm_T(p):
        c = p.mean(axis=0)
        s = np.sqrt(2) / np.mean(np.linalg.norm(p - c, axis=1))
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        return T

    To = norm_T(obj_xy)
    Ti = norm_T(img_xy)
    o = (np.column_stack([obj_xy, np.ones(len(obj_xy))]) @ To.T)[:, :2]
    i = (np.column_stack([img_xy, np.ones(len(img_xy))]) @ Ti.T)[:, :2]
    A = []
    for (x, y), (u, v) in zip(o, i):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return np.linalg.inv(Ti) @ H @ To


def _zhang_init(Hs: list[np.ndarray]) -> np.ndarray:
    """Closed-form K from >=3 homographies (Zhang 2000)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _calib_residuals(p: torch.Tensor, obj: torch.Tensor, img: torch.Tensor,
                     n_dist: int) -> torch.Tensor:
    """Reprojection residuals (...,V*N*2) of packed parameters (...,P)
    [fx, fy, cx, cy, dist(n_dist), rvecs(V*3), tvecs(V*3)]: the
    reference's project_points with the 8-coefficient model, the
    coefficients past n_dist zero."""
    V = obj.shape[0]
    lead = p.shape[:-1]
    fx, fy, cx, cy = (p[..., i, None, None] for i in range(4))
    k = [p[..., 4 + i, None, None] if i < n_dist else 0.0 for i in range(8)]
    k1, k2, p1, p2, k3, k4, k5, k6 = k
    o = 4 + n_dist
    rv = p[..., o:o + 3 * V].reshape(*lead, V, 3)
    tv = p[..., o + 3 * V:].reshape(*lead, V, 3)
    cam = obj @ rodrigues(rv).transpose(-1, -2) + tv[..., None, :]
    z = cam[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    x = cam[..., 0] / zsafe
    y = cam[..., 1] / zsafe
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
              / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
    xd = x * radial + (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
    yd = y * radial + (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
    proj = torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)
    return (proj - img).reshape(*lead, -1)


def _jacobian(fn, p: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian (M,P) of fn (P,) -> (M,) at p: the P basis
    tangents ride in one leading batch dimension."""
    P = p.shape[0]
    # torch.inference_mode() turns forward AD off; the duals are made
    # outside it
    with torch.inference_mode(False), fwAD.dual_level():
        dual = fwAD.make_dual(p.expand(P, P).contiguous(),
                              torch.eye(P, dtype=p.dtype, device=p.device))
        J = fwAD.unpack_dual(fn(dual)).tangent            # (P,M)
    return J.T


@functools.partial(jit, static_argnames=("n_dist",))
def _lm_step(p: torch.Tensor, lam: torch.Tensor, obj: torch.Tensor,
             img: torch.Tensor, n_dist: int):
    """One Levenberg-Marquardt step of ``calibrate_camera`` (the
    reference's scan body): packed parameters p (P,) and damping lam ()
    -> the next (p, lam). A step that does not lower the squared
    residuals keeps p and raises lam."""
    def residuals(q):
        return _calib_residuals(q, obj, img, n_dist)

    eye = torch.eye(p.shape[0], dtype=torch.float32, device=p.device)
    with cusolver(p.device):
        r = residuals(p)
        J = _jacobian(residuals, p)
        JTJ = J.T @ J
        g = J.T @ r
        # Jacobi column scaling: the parameters span orders of magnitude
        # (fx ~ 1e3 vs k3 ~ 1e-2)
        Dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(JTJ), min=1e-12))
        A = JTJ * Dinv[:, None] * Dinv[None, :]
        y = torch.linalg.solve_ex(A + lam * eye, (g * Dinv)[:, None]
                                  ).result[:, 0]
        p_new = p - y * Dinv
        better = torch.sum(residuals(p_new) ** 2) < torch.sum(r ** 2)
    lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-10),
                      torch.clamp(lam * 5.0, max=1e3))
    return torch.where(better, p_new, p), lam


def calibrate_camera(obj_pts: np.ndarray, img_pts: np.ndarray,
                     image_size: tuple[int, int], iters: int = 100,
                     n_dist: int = 5, device=None):
    """Batched-LM calibrateCamera.

    obj_pts (V,N,3) board points (z=0), img_pts (V,N,2) detected corners
    (host arrays). The Zhang initialisation runs on the host in float64;
    the LM runs on `device` (default CUDA, raising without a card;
    ``core/device.py``), ``_lm_step`` replayed `iters` times. Returns
    (K (3,3), dist (8,), rms, rvecs (V,3), tvecs (V,3)) as numpy."""
    dev = host_data_device(device)
    obj_pts = np.asarray(obj_pts)
    img_pts = np.asarray(img_pts)
    V, N = img_pts.shape[:2]
    Hs = [_homography_dlt(obj_pts[i, :, :2], img_pts[i]) for i in range(V)]
    K0 = _zhang_init(Hs)

    Rs, tvecs = [], []
    Kinv = np.linalg.inv(K0)
    for H in Hs:
        h1, h2, h3 = (Kinv @ H).T
        lam = 1.0 / np.linalg.norm(h1)
        if (lam * h3)[2] < 0:       # board must be in front of the camera
            lam = -lam
        r1 = lam * h1
        r2 = lam * h2
        r3 = np.cross(r1, r2)
        Rm = np.column_stack([r1, r2, r3])
        U, _, Vt = np.linalg.svd(Rm)
        Rs.append(U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt)
        tvecs.append(lam * h3)
    rvecs = rodrigues_inv(torch.from_numpy(np.asarray(Rs, np.float32))
                          ).numpy()
    tvecs = np.asarray(tvecs, dtype=np.float32)

    p = torch.from_numpy(np.concatenate([
        np.asarray([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]], np.float32),
        np.zeros(n_dist, np.float32), rvecs.reshape(-1),
        tvecs.reshape(-1)]).astype(np.float32)).to(dev)
    obj = torch.as_tensor(obj_pts, dtype=torch.float32, device=dev)
    img = torch.as_tensor(img_pts, dtype=torch.float32, device=dev)

    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    for _ in range(iters):
        p, lam = _lm_step(p, lam, obj, img, n_dist)

    r = _calib_residuals(p, obj, img, n_dist)
    rms = float(torch.sqrt(torch.mean(r ** 2)))
    p = p.cpu().numpy()
    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]],
                 dtype=np.float64)
    dist = np.concatenate([p[4:4 + n_dist], np.zeros(8 - n_dist, np.float32)])
    o = 4 + n_dist
    return (K, dist, rms, p[o:o + 3 * V].reshape(V, 3),
            p[o + 3 * V:].reshape(V, 3))
