"""Depth -> color alignment.

Port of ``repas_tpu/kernels/align.py::align_depth_to_color``: deproject
every depth pixel, move it into the color camera's frame, project it into
the color image and z-buffer it there, then close single-pixel holes.
The reference is XLA code, not a Pallas kernel; the port stays plain
PyTorch: the 2x2 footprint splat is one ``scatter_reduce_(..., "amin")``
per footprint offset on a flat buffer, the 3x3 hole fill a min-pool.
It is a compiled step (``core.jit``: on the card one CUDA graph per depth
shape, ``out_shape`` and ``fill_holes``); numpy intrinsics and
extrinsics are copied to the depth's device before the step.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.kernels.pointcloud import depth_image_to_points
from repas_tpu_torch.kernels.project import project_camera_points

_BIG = 1e9     # empty z-buffer value


@functools.partial(jit, static_argnames=("out_shape", "fill_holes"),
                   array_argnames=("K_depth", "K_color", "R_d2c", "t_d2c"))
def align_depth_to_color(depth_m: torch.Tensor, K_depth, K_color, R_d2c,
                         t_d2c, out_shape: tuple[int, int],
                         fill_holes: bool = True) -> torch.Tensor:
    """Warp depth images (...,H,W) in meters on the depth camera's grid
    onto the color grid (...,H_c,W_c), float32 meters, 0 where no depth
    projects. K_depth, K_color (3,3), R_d2c (3,3), t_d2c (3,): tensors on
    the depth's device or numpy arrays (copied there)."""
    hc, wc = out_shape
    dev = depth_m.device
    Kd, Kc, R, t = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in (K_depth, K_color, R_d2c, t_d2c))
    pts_c = depth_image_to_points(depth_m, Kd) @ R.T + t.reshape(3)
    uv = project_camera_points(pts_c, Kc)
    z = pts_c[..., 2]
    valid = (depth_m > 0) & (z > 1e-6)

    lead = depth_m.shape[:-2]
    n_img = lead.numel()
    u0 = torch.floor(uv[..., 0]).to(torch.int64).reshape(n_img, -1)
    v0 = torch.floor(uv[..., 1]).to(torch.int64).reshape(n_img, -1)
    zflat = torch.where(valid, z, _BIG).reshape(n_img, -1)
    base = torch.arange(n_img, device=dev)[:, None] * (hc * wc)
    out = torch.full((n_img * hc * wc,), _BIG, dtype=torch.float32,
                     device=dev)
    # splat into a 2x2 footprint to close sub-pixel gaps of the reproject
    for du in (0, 1):
        for dv in (0, 1):
            uu, vv = u0 + du, v0 + dv
            inb = (uu >= 0) & (uu < wc) & (vv >= 0) & (vv < hc)
            idx = torch.where(inb, base + vv * wc + uu, 0)
            out.scatter_reduce_(0, idx.reshape(-1),
                                torch.where(inb, zflat, _BIG).reshape(-1),
                                "amin")
    out = out.reshape(n_img, 1, hc, wc)
    if fill_holes:
        # remaining holes take the min of their 3x3 neighbourhood
        neigh = -F.max_pool2d(-out, 3, stride=1, padding=1)
        out = torch.where(out >= _BIG, neigh, out)
    return torch.where(out >= _BIG, 0.0, out).reshape(*lead, hc, wc)
