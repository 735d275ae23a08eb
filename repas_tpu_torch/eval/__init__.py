"""Error analysis and report writers (port of repas_tpu/eval)."""
from repas_tpu_torch.eval.reports import (correspondence_report,
                                          load_picked_points,
                                          point_to_mesh_distances,
                                          point_to_mesh_signed_distances,
                                          surface_error_report)

__all__ = ["correspondence_report", "load_picked_points",
           "point_to_mesh_distances", "point_to_mesh_signed_distances",
           "surface_error_report"]
