"""Multi-tag pose fusion: per-tag PnP, weighting, flip fix, quaternion
averaging and anchor choice.

Port of ``repas_tpu/pose/fusion.py`` (``FusedPose``, ``fuse_tag_poses``).
Batched over frames:

  * per-tag IPPE-square on the corners' known TL,TR,BR,BL order (the
    detector canonicalizes it), or with ``try_all_orders`` the 8-order
    search for corners of unknown order
  * weight_i = max(area,1e-3) / max(reproj_err,1e-3)
  * per-id 180-deg Z-flip fix (tag 9 by default)
  * weighted hemisphere-aligned quaternion average
  * anchor = configured id if present and valid, else argmax weight
  * depth-corrected translations P_depth

``fuse_tag_poses_jit`` is the compiled step (``core.jit``) beside the
plain function, which stays plain for the eager ``process_frames``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repas_tpu_torch.core.consts import const
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.core.transforms import average_rotations_quat, flip_z_180
from repas_tpu_torch.pose.depth_correct import depth_corrected_translation
from repas_tpu_torch.pose.pnp import (solve_pnp_best_order,
                                      solve_pnp_ippe_square)


class FusedPose(NamedTuple):
    """Result of multi-tag fusion (fixed capacity, batched over frames)."""

    R_avg: torch.Tensor          # (B,3,3) averaged rotation
    anchor_t: torch.Tensor       # (B,3) anchor PnP translation
    anchor_P_depth: torch.Tensor  # (B,3) depth-corrected anchor position
    anchor_idx: torch.Tensor     # (B,) int32 index into the detection slots
    R: torch.Tensor              # (B,N,3,3) per-tag rotations (post flip)
    t: torch.Tensor              # (B,N,3) per-tag translations
    P_depth: torch.Tensor        # (B,N,3) per-tag depth-corrected positions
    P_depth_valid: torch.Tensor  # (B,N) bool
    weights: torch.Tensor        # (B,N)
    err_px: torch.Tensor         # (B,N) reprojection errors
    order_idx: torch.Tensor      # (B,N) int32 winning corner order


def fuse_tag_poses(corners: torch.Tensor, ids: torch.Tensor,
                   areas: torch.Tensor, valid: torch.Tensor,
                   depth_m: torch.Tensor, K: torch.Tensor, tag_size_m: float,
                   anchor_id: int = 16, flip_z_ids=(9,),
                   win: int = 5, dist=None,
                   try_all_orders: bool = False) -> FusedPose:
    """corners (B,N,4,2) px, ids (B,N), areas (B,N), valid (B,N);
    depth_m (B,H,W) aligned to color; dist: distortion coefficients
    (None: an undistorted camera). Invalid slots are masked out: their
    PnP may be NaN (degenerate corners), and no NaN reaches the weights,
    the average or the anchor."""
    K = torch.as_tensor(K, dtype=torch.float32, device=corners.device)
    corners = corners.to(torch.float32)
    if try_all_orders:
        Rs, ts, errs, orders = solve_pnp_best_order(corners, K, tag_size_m,
                                                    dist=dist)
        orders = orders.to(torch.int32)
    else:
        Rs, ts, errs = solve_pnp_ippe_square(corners, K, tag_size_m,
                                             dist=dist)
        orders = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)

    flip_ids = const(tuple(flip_z_ids), ids.dtype, ids.device)
    needs_flip = torch.any(ids[..., None] == flip_ids, dim=-1)
    Rs = torch.where(needs_flip[..., None, None], flip_z_180(Rs), Rs)

    finite = (torch.all(torch.isfinite(Rs), dim=(-2, -1))
              & torch.all(torch.isfinite(ts), dim=-1)
              & torch.isfinite(errs))
    valid = valid & finite
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    Rs = torch.where(valid[..., None, None], Rs, eye)
    ts = torch.where(valid[..., None], ts,
                     const((0.0, 0.0, 1.0), ts.dtype, ts.device))
    errs = torch.where(valid, errs, 1e9)

    weights = torch.clamp(areas, min=1e-3) / torch.clamp(errs, min=1e-3)
    weights = torch.where(valid, weights, 0.0)

    Pd, Pd_valid = depth_corrected_translation(ts, depth_m, K, win=win)
    R_avg = average_rotations_quat(Rs, weights, mask=valid)

    # anchor: prefer anchor_id when present with valid depth, else max weight
    is_anchor = (ids == anchor_id) & valid & Pd_valid
    fallback = torch.argmax(torch.where(valid, weights, float("-inf")),
                            dim=-1)
    anchor_idx = torch.where(torch.any(is_anchor, dim=-1),
                             torch.argmax(is_anchor.to(torch.int32), dim=-1),
                             fallback)
    sel = anchor_idx[:, None, None]
    return FusedPose(
        R_avg=R_avg,
        anchor_t=torch.take_along_dim(ts, sel, dim=1)[:, 0],
        anchor_P_depth=torch.take_along_dim(Pd, sel, dim=1)[:, 0],
        anchor_idx=anchor_idx.to(torch.int32),
        R=Rs, t=ts, P_depth=Pd, P_depth_valid=Pd_valid,
        weights=weights, err_px=errs, order_idx=orders,
    )


# ``win`` and ``try_all_orders`` are static as in the reference;
# ``tag_size_m``, ``anchor_id`` and ``flip_z_ids``, which it traces, are
# static here: the first keys the object points' cached constant, the
# third the flip ids' (ROADMAP C, static departures)
fuse_tag_poses_jit = jit(
    fuse_tag_poses, static_argnames=("tag_size_m", "anchor_id", "flip_z_ids",
                                     "win", "try_all_orders"),
    array_argnames=("K", "dist"))
