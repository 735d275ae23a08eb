"""CLI entry points (port of repas_tpu/apps).

Run as `python -m repas_tpu_torch.apps.<command>`, with the reference's
arguments plus `--device` (default `cuda`):
  generate_pointcloud, crop_scene, place_cad, apply_6dof, refine_icp,
  ply_to_stl, detect_canopy, calibrate, error_report
"""
