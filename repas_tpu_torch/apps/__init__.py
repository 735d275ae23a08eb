"""CLI entry points (port of repas_tpu/apps).

Run as `python -m repas_tpu_torch.apps.<command>`, with the reference's
arguments plus `--device` (default `cuda`, raising without a card):
  detect_tags, estimate_pose, capture_aligned, generate_pointcloud,
  crop_scene, place_cad, refine_icp, apply_6dof, calibrate, detect_canopy,
  ply_to_stl, error_report, validate_pose, fetch_intrinsics,
  track_stream, fuse_views, align_depth, view_pointcloud, pack_replay
"""
