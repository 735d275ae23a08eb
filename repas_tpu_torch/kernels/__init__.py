"""Image, CCL, patch-extraction, point-cloud, projection, alignment and
color kernels (port of repas_tpu/kernels). The modules ``ccl_cuda``,
``ccl_tiled``, ``patch_extract`` and ``pointcloud`` launch hand-written
CUDA kernels (``csrc/``) on CUDA tensors and run their plain PyTorch
versions on CPU tensors."""
from repas_tpu_torch.kernels.project import (
    deproject_pixels,
    distort_normalized,
    project_points,
    reprojection_error,
    undistort_points,
)
from repas_tpu_torch.kernels.pointcloud import (
    depth_image_to_points,
    depth_to_meters,
    median_depth_window,
    rgbd_to_pointcloud,
)
from repas_tpu_torch.kernels.align import align_depth_to_color
from repas_tpu_torch.kernels.ccl import connected_components, top_k_components
from repas_tpu_torch.kernels.color import (frame_to_rgb, nv12_to_rgb,
                                           yuyv_to_rgb)
from repas_tpu_torch.kernels import image

__all__ = [
    "project_points", "deproject_pixels", "undistort_points",
    "distort_normalized", "reprojection_error", "depth_to_meters",
    "depth_image_to_points", "rgbd_to_pointcloud", "median_depth_window",
    "align_depth_to_color", "connected_components", "top_k_components",
    "frame_to_rgb", "nv12_to_rgb", "yuyv_to_rgb", "image",
]
