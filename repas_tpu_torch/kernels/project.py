"""Pinhole projection for an undistorted camera.

Port of ``repas_tpu/kernels/project.py`` (``project_points``,
``project_camera_points``) for ``dist=None``: the frame pipeline's
default. The Brown-Conrady model is not ported yet.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.core.transforms import rodrigues


def project_points(pts: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """cv2.projectPoints: object points (...,N,3) -> pixels (...,N,2).

    rvec is (...,3) axis-angle or (...,3,3) rotation; tvec (...,3).
    """
    R = rvec if rvec.shape[-2:] == (3, 3) else rodrigues(rvec)
    cam = pts @ R.transpose(-1, -2) + tvec[..., None, :]
    return project_camera_points(cam, K)


def project_camera_points(cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixel coords (...,2)."""
    z = cam[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    xy = cam[..., :2] / zsafe[..., None]
    u = K[0, 0] * xy[..., 0] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)
