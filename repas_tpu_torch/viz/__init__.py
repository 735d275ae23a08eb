"""Visualisation: the headless matplotlib scenes, the depth colorizer,
the z-buffer splat renderer (on tensors, on the points' device) and the
self-contained HTML viewer (port of repas_tpu/viz). matplotlib is
imported only when a figure is drawn."""
from repas_tpu_torch.viz.colormap import colorize_depth, jet_colormap
from repas_tpu_torch.viz.scene import (aabb_wireframe_segments, axes_points,
                                       draw_detections,
                                       draw_reprojection_compare,
                                       line_points, make_xy_grid_lines,
                                       plot_pointcloud, save_color_scale,
                                       save_pointcloud_views, sphere_points)
from repas_tpu_torch.viz.render import (look_at, orbit_views,
                                        rasterize_segments, render_pointcloud)
from repas_tpu_torch.viz.html_viewer import write_html_viewer

__all__ = ["draw_detections", "draw_reprojection_compare", "plot_pointcloud",
           "save_pointcloud_views", "make_xy_grid_lines", "axes_points",
           "sphere_points", "aabb_wireframe_segments", "line_points",
           "save_color_scale", "colorize_depth", "jet_colormap",
           "render_pointcloud", "look_at", "orbit_views",
           "rasterize_segments", "write_html_viewer"]
