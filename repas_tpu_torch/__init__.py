"""repas_tpu_torch — PyTorch + CUDA port of the repas_tpu RGB-D pipeline.

Port of ``repas_tpu/__init__.py``. The JAX package ``repas_tpu`` stays the
reference; this package mirrors its layout and imports torch and numpy,
never jax and nothing from ``repas_tpu``:

  core/     config tree, precision policy, SO(3) helpers, device rule
  kernels/  image ops, CCL, patch extraction, point cloud, Brown-Conrady
            projection, depth-to-color alignment, YUV decoding, and the
            hand-written Hopper kernels (``kernels/csrc``) that replace
            the reference's Pallas kernels
  detect/   tag36h11 codebook, synthetic renderer, batched detector,
            robust retry ladder
  pose/     IPPE-square + LM PnP (and its best corner order), the
            detector's homography pose, SQPnP, depth correction,
            multi-tag fusion, tag bundles, register-then-track streaming
  pipeline  ``process_frames``: detect -> PnP -> fusion -> point cloud,
            for an undistorted or a calibrated camera
  cloud/    grid-hash k-NN, voxel and outlier filters, normals, FPFH +
            RANSAC, point-to-plane ICP, ``register_clouds``, the
            tag-anchored crop, masked cloud generation, CAD placement
            and ICP refinement (``cad``), Poisson / alpha-shape / ball-
            pivoting surface reconstruction (``reconstruct``)
  io/       PLY / STL geometry, sidecar metadata, pose txt, images (the
            native PNG codec, built at first use), byte-identical to the
            reference's writers; the replay camera backend and the
            pose-sequence dataset
  canopy/   plant-canopy height: Canny + Hough bar detection, colour-
            model plant segmentation, ``measure_plant_height``
  calib/    checkerboard corners, sub-pixel refinement, Zhang + LM
            ``calibrate_camera``
  eval/     correspondence and point-to-mesh error reports
  parallel/ the single-controller frame mesh: shards of a batch run on
            a list of devices (one may repeat), each on its own stream
  viz/      host matplotlib scenes, the depth colorizer, the z-buffer
            splat renderer and the self-contained HTML viewer
  utils/    the [TAG]-prefixed loggers and the profiling hooks
  apps/     the reference's 19 CLIs
            (``python -m repas_tpu_torch.apps.<name> ... --device cuda``)

Entry points that take tensors run where their inputs lie. Entry points
that take host data (``pose.track.TagTracker``, the YUV formats of
``kernels.color.frame_to_rgb``, numpy clouds given to
``cloud.register_clouds`` / ``global_register_fpfh``, the host geometry
of ``cloud.cad.refine_with_icp`` and ``cloud.reconstruct``'s
``reconstruct_surface`` / ``ball_pivot``, ``calib.calibrate_camera``,
and every CLI's ``--device``)
run on the card unless given ``device``, and raise without one
(``core/device.py``).
"""

__version__ = "0.1.0"

from repas_tpu_torch.core.precision import set_precision_policy

set_precision_policy()

from repas_tpu_torch.core.transforms import (  # noqa: E402
    R_to_euler_zyx, T_rotate_about_point, T_scale_about_point, T_translate,
    apply_T, cv_to_o3d_R, cv_to_o3d_t, euler_zyx_to_R, invert_T,
    is_valid_transform, make_T, quat_multiply, rotation_angle_deg,
    tag_local_to_camera)
from repas_tpu_torch.cloud import (  # noqa: E402
    aabb_mask, compact_masked, create_masked_pointcloud, estimate_normals,
    estimate_normals_grid, global_register_fpfh, grid_hash_build,
    grid_hash_query, grid_hash_query_knn, icp_point_to_plane, knn_neighbors,
    nearest_neighbors, obb_from_tag, radius_mask, register_clouds,
    statistical_outlier_mask, tag_frame_aabb_crop, voxel_downsample)
from repas_tpu_torch.cloud.registration import (  # noqa: E402
    ICPResult, evaluate_registration)

__all__ = [
    "set_precision_policy", "quat_multiply", "euler_zyx_to_R",
    "R_to_euler_zyx", "make_T", "T_translate", "T_rotate_about_point",
    "T_scale_about_point", "apply_T", "invert_T", "cv_to_o3d_R",
    "cv_to_o3d_t", "tag_local_to_camera", "rotation_angle_deg",
    "is_valid_transform", "radius_mask", "statistical_outlier_mask",
    "voxel_downsample", "compact_masked", "estimate_normals",
    "estimate_normals_grid", "grid_hash_build", "grid_hash_query",
    "grid_hash_query_knn", "knn_neighbors", "nearest_neighbors",
    "tag_frame_aabb_crop", "aabb_mask", "obb_from_tag",
    "create_masked_pointcloud", "global_register_fpfh",
    "icp_point_to_plane", "register_clouds", "evaluate_registration",
    "ICPResult",
]
