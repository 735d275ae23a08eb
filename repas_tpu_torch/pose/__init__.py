"""PnP solvers, depth correction, multi-tag fusion, tag bundles and the
register-then-track streamer (port of repas_tpu/pose)."""
from repas_tpu_torch.pose.pnp import (
    SQUARE_ORDERS,
    detector_pose,
    refine_pnp_gn,
    solve_pnp_best_order,
    solve_pnp_ippe_square,
    solve_pnp_sqpnp,
    square_object_points,
)
from repas_tpu_torch.pose.depth_correct import (depth_corrected_translation,
                                                z_scale_correction)
from repas_tpu_torch.pose.fusion import FusedPose, fuse_tag_poses
from repas_tpu_torch.pose.bundle import solve_tag_bundle
from repas_tpu_torch.pose.track import TagTracker, TrackerConfig, TrackResult

__all__ = [
    "solve_pnp_ippe_square", "solve_pnp_best_order", "solve_pnp_sqpnp",
    "refine_pnp_gn", "detector_pose", "SQUARE_ORDERS",
    "square_object_points", "depth_corrected_translation",
    "z_scale_correction", "fuse_tag_poses", "FusedPose", "solve_tag_bundle",
    "TagTracker", "TrackerConfig", "TrackResult",
]
