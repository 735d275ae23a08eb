"""Multi-tag pose fusion: per-tag PnP, weighting, flip fix, quaternion
averaging and anchor choice.

Port of ``repas_tpu/pose/fusion.py`` (``FusedPose``, ``fuse_tag_poses``).
Batched over frames:

  * per-tag IPPE-square on the corners' known TL,TR,BR,BL order (the
    detector canonicalizes it), or with ``try_all_orders`` the 8-order
    search for corners of unknown order
  * weight_i = max(area,1e-3) / max(reproj_err,1e-3), the error each
    pose's mean corner distance in float64 from the pose as output
    (rotation through its unit quaternion)
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
from repas_tpu_torch.core.transforms import (R_to_quat, average_rotations_quat,
                                             flip_z_180, quat_to_R)
from repas_tpu_torch.kernels.project import project_points
from repas_tpu_torch.pose.depth_correct import depth_corrected_translation
from repas_tpu_torch.pose.pnp import (SQUARE_ORDERS, solve_pnp_best_order,
                                      solve_pnp_ippe_square,
                                      square_object_points)


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


def pose_residual_f64(R: torch.Tensor, t: torch.Tensor, img: torch.Tensor,
                      K: torch.Tensor, tag_size_m: float, dist=None
                      ) -> torch.Tensor:
    """Mean distance in pixels, in float64, between the tag corners of
    poses (R (...,3,3), t (...,3)) projected and `img` (...,4,2): the
    rotation taken through its unit quaternion, the other values as they
    are. The solver's own float32 error rounds 600 px coordinates, about
    5e-5 px, which is a few percent of the thousandths of a pixel that a
    clean tag's pose leaves; the weights divide by this error, and the
    weighted mean of rotations far apart (tags turned differently in one
    frame) moves by as much as those weights. The solvers keep their
    float32 error: it picks among IPPE branches and corner orders whose
    errors tie to within rounding, and in float64 that pick departs from
    the reference's (a near-frontal tag's branch flips)."""
    f64 = torch.float64
    Rq = quat_to_R(R_to_quat(R.to(f64)))
    obj = square_object_points(tag_size_m, img.device).to(f64)
    proj = project_points(obj, Rq, t.to(f64), K.to(f64),
                          None if dist is None else dist.to(f64))
    return torch.linalg.vector_norm(proj - img.to(f64), dim=-1).mean(-1)


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
        # the corners as the winning order paired them
        inv = const(tuple(tuple(int(i) for i in o)
                          for o in SQUARE_ORDERS.argsort(-1)), torch.int64,
                    corners.device)
        paired = torch.take_along_dim(corners[..., inv, :],
                                      orders[..., None, None, None], dim=-3
                                      )[..., 0, :, :]
        orders = orders.to(torch.int32)
    else:
        Rs, ts, errs = solve_pnp_ippe_square(corners, K, tag_size_m,
                                             dist=dist)
        orders = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
        paired = corners
    errs = pose_residual_f64(Rs, ts, paired, K, tag_size_m, dist).to(
        errs.dtype)

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
