"""Multi-tag bundle PnP.

Port of ``repas_tpu/pose/bundle.py::solve_tag_bundle``: given a known
layout of tag centers in one plane, stack 4 corners and the center of
every detected tag and solve one SQPnP for the camera pose in the layout
frame. Corners arrive in the detector's canonical TL,TR,BR,BL order.
``solve_tag_bundle_jit`` is its compiled step (``core.jit``).
"""
from __future__ import annotations

import numpy as np
import torch

from repas_tpu_torch.core.consts import const
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.pose.pnp import solve_pnp_sqpnp


def solve_tag_bundle(corners: torch.Tensor, centers_px: torch.Tensor,
                     valid: torch.Tensor, world_centers: torch.Tensor,
                     tag_size_m: float, K: torch.Tensor, dist=None):
    """corners (...,M,4,2) detected pixel corners (TL,TR,BR,BL), centers_px
    (...,M,2), valid (...,M) mask, world_centers (...,M,3) tag centers in
    the layout frame (z = 0 plane). Masked slots may hold anything.

    Returns (R (...,3,3), t (...,3), mean_reproj_err_px (...)): the
    layout-to-camera pose."""
    dev = corners.device
    h = float(np.float32(tag_size_m)) / 2.0
    offs = const(((-h, -h, 0.0), (h, -h, 0.0), (h, h, 0.0), (-h, h, 0.0)),
                 torch.float32, dev)
    world = world_centers.to(torch.float32)
    obj_corners = world[..., :, None, :] + offs                # (...,M,4,3)
    lead = obj_corners.shape[:-3]
    obj = torch.cat([obj_corners.reshape(*lead, -1, 3), world], dim=-2)
    img = torch.cat([corners.reshape(*corners.shape[:-3], -1, 2),
                     centers_px], dim=-2).to(torch.float32)
    v = valid.to(torch.float32)
    w = torch.cat([torch.repeat_interleave(v, 4, dim=-1), v], dim=-1)
    return solve_pnp_sqpnp(obj, img, K, dist, weights=w)


# ``tag_size_m``, which the reference traces, is static: it keys the
# corner offsets' cached constant (ROADMAP C, static departures)
solve_tag_bundle_jit = jit(solve_tag_bundle, static_argnames=("tag_size_m",),
                           array_argnames=("K", "dist"))
