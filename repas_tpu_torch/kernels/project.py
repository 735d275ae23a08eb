"""Pinhole + Brown-Conrady projection math.

Port of ``repas_tpu/kernels/project.py`` (``distort_normalized``,
``undistort_points``, ``project_points``, ``project_camera_points``,
``deproject_pixels``, ``reprojection_error``). The distortion model is
OpenCV's 8-coefficient rational Brown-Conrady (k1,k2,p1,p2,k3,k4,k5,k6);
a shorter vector pads with zeros. ``dist=None`` skips the polynomial
(an undistorted camera: the frame pipeline's default); any ``dist``
always applies it, the identity at zero coefficients.

Every function broadcasts over leading dimensions and waits for nothing
on the device: the coefficients are read by indexing, never on the host.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.core.transforms import rodrigues


def _coeffs(dist: torch.Tensor):
    """k1, k2, p1, p2, k3, k4, k5, k6 of a (n,) coefficient vector,
    n >= 5; missing rational terms are zero."""
    zero = torch.zeros_like(dist[0])
    return tuple(dist[i] if i < dist.shape[0] else zero for i in range(8))


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply Brown-Conrady distortion to normalized image coords (...,2)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    radial = num / den
    xt = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + xt, y * radial + yt], dim=-1)


def undistort_points(uv: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                     iters: int = 10) -> torch.Tensor:
    """Pixel coords (...,2) -> undistorted normalized coords (...,2) by
    `iters` fixed-point steps (cv2.undistortPoints)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    target = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy],
                         dim=-1)
    xy = target
    for _ in range(iters):
        xy = xy + (target - distort_normalized(xy, dist))
    return xy


def project_points(pts: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   K: torch.Tensor, dist=None) -> torch.Tensor:
    """cv2.projectPoints: object points (...,N,3) -> pixels (...,N,2).

    rvec is (...,3) axis-angle or (...,3,3) rotation; tvec (...,3).
    """
    R = rvec if rvec.shape[-2:] == (3, 3) else rodrigues(rvec)
    cam = pts @ R.transpose(-1, -2) + tvec[..., None, :]
    return project_camera_points(cam, K, dist)


def project_camera_points(cam: torch.Tensor, K: torch.Tensor,
                          dist=None) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixel coords (...,2)."""
    z = cam[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    xy = cam[..., :2] / zsafe[..., None]
    if dist is not None:
        xy = distort_normalized(xy, dist)
    u = K[0, 0] * xy[..., 0] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def deproject_pixels(uv: torch.Tensor, depth: torch.Tensor, K: torch.Tensor,
                     dist=None, undistort_iters: int = 10) -> torch.Tensor:
    """Pixels (...,2) + depth (...) -> camera-frame points (...,3):
    X=(u-cx)Z/fx, Y=(v-cy)Z/fy, Z=Z, after undistorting when `dist` is
    given."""
    if dist is not None:
        xy = undistort_points(uv, K, dist, iters=undistort_iters)
    else:
        xy = torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0],
                          (uv[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)
    return torch.cat([xy * depth[..., None], depth[..., None]], dim=-1)


def reprojection_error(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                       rvec: torch.Tensor, tvec: torch.Tensor,
                       K: torch.Tensor, dist=None) -> torch.Tensor:
    """Mean L2 pixel error (...) of projected vs detected points (...,N,2)."""
    proj = project_points(obj_pts, rvec, tvec, K, dist)
    return torch.mean(torch.linalg.vector_norm(proj - img_pts, dim=-1),
                      dim=-1)
