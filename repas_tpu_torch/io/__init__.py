"""Host I/O: images, PLY/STL geometry, pose txt and sidecar metadata (port
of repas_tpu/io; host numpy, byte-identical writers)."""
from repas_tpu_torch.io.image import read_image, write_image, read_depth_png, write_depth_png
from repas_tpu_torch.io.ply import PointCloud, TriangleMesh, read_ply, write_ply, read_stl, write_stl, read_geometry
from repas_tpu_torch.io.pose_txt import load_transform_txt, save_transform_txt
from repas_tpu_torch.io.meta import write_meta, read_meta

__all__ = [
    "read_image", "write_image", "read_depth_png", "write_depth_png",
    "PointCloud", "TriangleMesh", "read_ply", "write_ply", "read_stl",
    "write_stl", "read_geometry", "load_transform_txt", "save_transform_txt",
    "write_meta", "read_meta",
]
