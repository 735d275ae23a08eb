"""SO(3) / SE(3) helpers, quaternions, frame conventions and the
unit-square homography.

Port of ``repas_tpu/core/transforms.py``. The reference writes most of
these for one matrix and vmaps them; here every function broadcasts over
leading dimensions, written out: rotations (...,3,3), 4x4 transforms
(...,4,4), vectors (...,3). ``apply_T`` and ``tag_local_to_camera`` take
point sets (...,N,3) against one transform per leading index.
"""
from __future__ import annotations

import math

import torch

from repas_tpu_torch.core.consts import const

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix of (...,3) vectors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (...,3) -> rotation (...,3,3). Safe at theta -> 0.

    R = I + sin(t)/t K + (1-cos(t))/t^2 K^2 with K = skew(rvec).
    """
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-10
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    # skew(r)^2 == r r^T - |r|^2 I exactly; outer product avoids a matmul
    outer = rvec[..., :, None] * rvec[..., None, :]
    K2 = outer - theta2[..., None, None] * eye
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def rodrigues_inv(R: torch.Tensor) -> torch.Tensor:
    """Rotation (...,3,3) -> axis-angle (...,3). Handles theta near 0, pi."""
    tr = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0,
                     -1.0, 1.0)
    theta = torch.arccos(tr)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    generic = w * (theta / (2.0 * sin_t + _EPS))[..., None]
    small = w * 0.5
    # theta ~ pi: axis from the diagonal of (R + I)/2
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) / 2.0
    axis2 = torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1), min=0.0)
    axis = torch.sqrt(axis2 + _EPS)
    i = torch.argmax(axis2, dim=-1)
    row_i = torch.take_along_dim(B, i[..., None, None], dim=-2)[..., 0, :]
    axis_i = torch.take_along_dim(axis, i[..., None], dim=-1)
    axis_pi = axis * torch.sign(row_i + _EPS) * torch.sign(axis_i + _EPS)
    axis_pi = axis_pi / (torch.linalg.vector_norm(axis_pi, dim=-1,
                                                  keepdim=True) + _EPS)
    near_pi = (theta > (math.pi - 1e-3))[..., None]
    near_0 = (theta < 1e-5)[..., None]
    return torch.where(near_0, small,
                       torch.where(near_pi, axis_pi * theta[..., None],
                                   generic))


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation (...,3,3) -> unit quaternion (...,4) (w,x,y,z), w >= 0.
    Shepperd's method, branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22,
                      m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 + m22 - m00 - m11], dim=-1)
    vals = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1)
    idx = torch.argmax(vals, dim=-1)[..., None]
    q = torch.where(idx == 0, q0,
                    torch.where(idx == 1, q1, torch.where(idx == 2, q2, q3)))
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (...,4) (w,x,y,z) -> rotation (...,3,3)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (...,4) (w,x,y,z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def average_rotations_quat(Rs: torch.Tensor, weights: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Weighted hemisphere-aligned quaternion average.

    Rs (...,N,3,3), weights (...,N), mask (...,N) bool -> (...,3,3).
    Weights are clipped to >= 1e-6 and normalized; every quaternion is
    aligned to the first kept one's hemisphere before the weighted sum.
    """
    w = torch.clamp(weights.to(Rs.dtype), min=1e-6)
    w = torch.where(mask, w, 0.0)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + _EPS)
    Q = R_to_quat(Rs)
    # masked slots may hold NaN rotations; 0-weight alone does not stop
    # 0*NaN = NaN, so zero the quaternions themselves
    keep = torch.all(torch.isfinite(Q), dim=-1) & mask
    Q = torch.where(keep[..., None], Q, 0.0)
    w = torch.where(keep, w, 0.0)
    first = torch.argmax(keep.to(torch.int32), dim=-1)
    q_ref = torch.take_along_dim(Q, first[..., None, None], dim=-2)
    sign = torch.where(torch.sum(Q * q_ref, dim=-1, keepdim=True) < 0,
                       -1.0, 1.0)
    Q = Q * sign
    q_avg = torch.sum(w[..., None] * Q, dim=-2)
    q_avg = q_avg / (torch.linalg.vector_norm(q_avg, dim=-1, keepdim=True)
                     + _EPS)
    return quat_to_R(q_avg)


def _f32(x) -> torch.Tensor:
    """A tensor as given; anything else as a float32 tensor."""
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float32)


def euler_zyx_to_R(z_deg, y_deg, x_deg) -> torch.Tensor:
    """R = Rz @ Ry @ Rx from degrees (float32; broadcasts the angles)."""
    z, y, x = (torch.deg2rad(_f32(a).to(torch.float32))
               for a in (z_deg, y_deg, x_deg))
    z, y, x = torch.broadcast_tensors(z, y, x)
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    one = torch.ones_like(cz)
    zero = torch.zeros_like(cz)
    Rz = torch.stack([torch.stack([cz, -sz, zero], -1),
                      torch.stack([sz, cz, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    Ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cx, -sx], -1),
                      torch.stack([zero, sx, cx], -1)], -2)
    return Rz @ Ry @ Rx


def R_to_euler_zyx(R: torch.Tensor):
    """Rotation (...,3,3) -> (z, y, x) degrees, ZYX convention."""
    y = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    z = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    x = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    return torch.rad2deg(z), torch.rad2deg(y), torch.rad2deg(x)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation + (...,3) translation -> (...,4,4), R's dtype."""
    R, t = _f32(R), _f32(t)
    lead = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(*lead, 3, 3),
                     t.to(R.dtype).expand(*lead, 3)[..., None]], dim=-1)
    bottom = const(((0.0, 0.0, 0.0, 1.0),), R.dtype, R.device)
    return torch.cat([top, bottom.expand(*lead, 1, 4)], dim=-2)


def T_translate(t) -> torch.Tensor:
    t = _f32(t)
    return make_T(torch.eye(3, dtype=t.dtype, device=t.device), t)


def T_rotate_about_point(R, p) -> torch.Tensor:
    """Rotate by R about fixed point p: x -> R (x - p) + p."""
    R = _f32(R)
    p = _f32(p).to(R.dtype)
    return make_T(R, p - (R @ p[..., None])[..., 0])


def T_scale_about_point(s, p) -> torch.Tensor:
    """Uniform scale s about fixed point p: x -> s (x - p) + p."""
    p = _f32(p)
    s = torch.as_tensor(s, dtype=p.dtype, device=p.device)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    return make_T(eye * s[..., None, None], p - s[..., None] * p)


def apply_T(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) transforms to point sets (...,N,3), or to one
    point (3,)."""
    one = pts.dim() == 1
    p = pts[None] if one else pts
    out = p @ T[..., :3, :3].mT + T[..., None, :3, 3]
    return out[..., 0, :] if one else out


def invert_T(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].mT
    return make_T(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


# OpenCV camera frame (x right, y down, z forward) <-> Open3D viewer frame
# (x right, y up, z backward): S = diag(1,-1,-1). S @ R @ S only flips the
# signs of R's off-block entries, so it is written as that product.
_S_CV_O3D_SIGNS = ((1.0, -1.0, -1.0), (-1.0, 1.0, 1.0), (-1.0, 1.0, 1.0))


def cv_to_o3d_R(R: torch.Tensor) -> torch.Tensor:
    return R * const(_S_CV_O3D_SIGNS, R.dtype, R.device)


def cv_to_o3d_t(t: torch.Tensor) -> torch.Tensor:
    t = _f32(t)
    return t * const((1.0, -1.0, -1.0), t.dtype, t.device)


def tag_local_to_camera(p_local: torch.Tensor, R: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """Points (...,3) from the tag-local to the camera frame."""
    return _f32(p_local) @ R.mT + t


def rotation_angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotations (...,3,3), in degrees."""
    Rrel = Ra.mT @ Rb
    tr = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    c = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(c))


def is_valid_transform(T, tol: float = 1e-6):
    """(det(R) ~ 1 and R R^T ~ I, ||R R^T - I||_F) for (...,4,4) T; both
    checks at 1e-3, as in the reference (which ignores `tol`)."""
    R = _f32(T)[..., :3, :3]
    det_ok = torch.abs(torch.linalg.det(R) - 1.0) < 1e-3
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    ortho = torch.linalg.matrix_norm(R @ R.mT - eye)
    return det_ok & (ortho < 1e-3), ortho


def flip_z_180(R: torch.Tensor) -> torch.Tensor:
    """The 180-deg Z rotation correction R @ diag(-1,-1,1) (tag-9 fix).
    Negating the first two columns is that product, bit for bit."""
    return R * const((-1.0, -1.0, 1.0), R.dtype, R.device)


def homography_from_unit_square(quad: torch.Tensor) -> torch.Tensor:
    """Exact homography (...,3,3), H33 = 1, mapping TL=(-1,-1), TR=(1,-1),
    BR=(1,1), BL=(-1,1) onto the 4 points of `quad` (...,4,2), in order.
    Closed form (projective bilinear map over the unit square)."""
    x0, y0 = quad[..., 0, 0], quad[..., 0, 1]
    x1, y1 = quad[..., 1, 0], quad[..., 1, 1]
    x2, y2 = quad[..., 2, 0], quad[..., 2, 1]
    x3, y3 = quad[..., 3, 0], quad[..., 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1 = x1 - x2
    dx2 = x3 - x2
    dy1 = y1 - y2
    dy2 = y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    H = torch.stack([
        torch.stack([0.5 * a, 0.5 * b, 0.5 * (a + b) + x0], dim=-1),
        torch.stack([0.5 * d, 0.5 * e, 0.5 * (d + e) + y0], dim=-1),
        torch.stack([0.5 * g, 0.5 * h, 0.5 * (g + h) + 1.0], dim=-1),
    ], dim=-2)
    w = H[..., 2, 2]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return H / w[..., None, None]
