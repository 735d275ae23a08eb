"""Host-side visualisation: the headless matplotlib scenes and the depth
colorizer (port of repas_tpu/viz without ``render`` and ``html_viewer``,
which are not ported yet). matplotlib is imported only when a figure is
drawn."""
from repas_tpu_torch.viz.colormap import colorize_depth, jet_colormap
from repas_tpu_torch.viz.scene import (aabb_wireframe_segments, axes_points,
                                       draw_detections,
                                       draw_reprojection_compare,
                                       line_points, make_xy_grid_lines,
                                       plot_pointcloud, save_color_scale,
                                       save_pointcloud_views, sphere_points)

__all__ = ["draw_detections", "draw_reprojection_compare", "plot_pointcloud",
           "save_pointcloud_views", "make_xy_grid_lines", "axes_points",
           "sphere_points", "aabb_wireframe_segments", "line_points",
           "save_color_scale", "colorize_depth", "jet_colormap"]
