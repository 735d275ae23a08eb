"""PnP solvers, depth correction, multi-tag fusion, tag bundles and the
register-then-track streamer (port of repas_tpu/pose)."""
from repas_tpu_torch.pose.pnp import (
    SQUARE_ORDERS,
    detector_pose,
    refine_pnp_gn,
    refine_pnp_gn_jit,
    solve_pnp_best_order,
    solve_pnp_best_order_jit,
    solve_pnp_ippe_square,
    solve_pnp_ippe_square_jit,
    solve_pnp_sqpnp,
    solve_pnp_sqpnp_jit,
    square_object_points,
)
from repas_tpu_torch.pose.depth_correct import (depth_corrected_translation,
                                                z_scale_correction)
from repas_tpu_torch.pose.fusion import (FusedPose, fuse_tag_poses,
                                         fuse_tag_poses_jit)
from repas_tpu_torch.pose.bundle import solve_tag_bundle, solve_tag_bundle_jit
from repas_tpu_torch.pose.track import TagTracker, TrackerConfig, TrackResult

__all__ = [
    "solve_pnp_ippe_square", "solve_pnp_best_order", "solve_pnp_sqpnp",
    "refine_pnp_gn", "detector_pose", "SQUARE_ORDERS",
    "square_object_points", "depth_corrected_translation",
    "z_scale_correction", "fuse_tag_poses", "FusedPose", "solve_tag_bundle",
    "TagTracker", "TrackerConfig", "TrackResult",
    # the compiled steps beside the plain functions (core.jit)
    "solve_pnp_ippe_square_jit", "solve_pnp_best_order_jit",
    "solve_pnp_sqpnp_jit", "refine_pnp_gn_jit", "fuse_tag_poses_jit",
    "solve_tag_bundle_jit",
]
