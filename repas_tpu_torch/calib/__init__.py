"""Checkerboard camera calibration (port of repas_tpu/calib)."""
from repas_tpu_torch.calib.checkerboard import (calibrate_camera,
                                                detect_checkerboard_corners,
                                                refine_corners_subpix)

__all__ = ["detect_checkerboard_corners", "refine_corners_subpix",
           "calibrate_camera"]
