"""Point-cloud filters, normals, grid-hash k-NN, cropping, generation,
FPFH + RANSAC, point-to-plane ICP, CAD placement (``cad``) and surface
reconstruction (``reconstruct``) (port of repas_tpu/cloud)."""
from repas_tpu_torch.cloud.filters import (compact_masked, radius_mask,
                                           statistical_outlier_mask,
                                           voxel_downsample)
from repas_tpu_torch.cloud.normals import (estimate_normals,
                                           estimate_normals_grid)
from repas_tpu_torch.cloud.knn import (grid_hash_build, grid_hash_query,
                                       grid_hash_query_knn, knn_neighbors,
                                       nearest_neighbors)
from repas_tpu_torch.cloud.crop import (tag_frame_aabb_crop, aabb_mask,
                                        obb_from_tag)
from repas_tpu_torch.cloud.generate import create_masked_pointcloud
from repas_tpu_torch.cloud.registration import (global_register_fpfh,
                                                icp_point_to_plane,
                                                register_clouds)
from repas_tpu_torch.cloud.cad import (apply_pose_txt, place_cad_at_anchor,
                                       refine_with_icp, transform_geometry)
from repas_tpu_torch.cloud.reconstruct import (alpha_shape, ball_pivot,
                                               poisson_indicator_grid,
                                               reconstruct_surface,
                                               surface_nets)

__all__ = [
    "radius_mask", "statistical_outlier_mask", "voxel_downsample",
    "compact_masked",
    "estimate_normals", "estimate_normals_grid", "grid_hash_build",
    "grid_hash_query",
    "nearest_neighbors", "tag_frame_aabb_crop", "aabb_mask", "obb_from_tag",
    "create_masked_pointcloud", "grid_hash_query_knn", "knn_neighbors",
    "global_register_fpfh", "icp_point_to_plane", "register_clouds",
    "place_cad_at_anchor", "refine_with_icp", "transform_geometry",
    "apply_pose_txt", "poisson_indicator_grid", "surface_nets",
    "reconstruct_surface", "ball_pivot", "alpha_shape",
]
