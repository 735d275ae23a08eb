"""Tag-anchored scene cropping.

Port of ``repas_tpu/cloud/crop.py``: a box given in the tag-local frame by
front/back offsets per axis, its 8 corners moved to the camera frame, and
the cloud masked by the camera-frame AABB of those corners (as the
reference does: an AABB, not an oriented-box test).
"""
from __future__ import annotations

import torch

from repas_tpu_torch.core.config import CropConfig


def obb_from_tag(R, t, cfg: CropConfig) -> torch.Tensor:
    """(8,3) box corners in the camera frame from the tag pose (R, t), on
    R's device: the box spans [-dx_back, dx_front] x [-dy_back, dy_front]
    x [-dz_back, dz_front] in the tag frame."""
    R = torch.as_tensor(R, dtype=torch.float32)
    t = torch.as_tensor(t, dtype=torch.float32).to(R.device).reshape(3)
    xs = (cfg.dx_front, -cfg.dx_back)
    ys = (cfg.dy_front, -cfg.dy_back)
    zs = (cfg.dz_front, -cfg.dz_back)
    corners = torch.tensor([[x, y, z] for x in xs for y in ys for z in zs],
                           dtype=torch.float32).to(R.device)
    return corners @ R.T + t


def aabb_mask(pts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              pad: float = 0.0) -> torch.Tensor:
    """Inside-AABB mask of (...,3) points."""
    return torch.all((pts >= lo - pad) & (pts <= hi + pad), dim=-1)


def tag_frame_aabb_crop(pts: torch.Tensor, mask: torch.Tensor, R, t,
                        cfg: CropConfig):
    """Crop a cloud to the tag-anchored box, on the cloud's device.

    Returns (mask', aabb_lo, aabb_hi, box_corners_cam)."""
    R = torch.as_tensor(R, dtype=torch.float32).to(pts.device)
    corners = obb_from_tag(R, t, cfg)
    lo = torch.amin(corners, dim=0)
    hi = torch.amax(corners, dim=0)
    return mask & aabb_mask(pts, lo, hi, pad=cfg.pad_m), lo, hi, corners
