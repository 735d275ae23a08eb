"""Plant-canopy height: bar detection, plant segmentation and the height
measurement (port of repas_tpu/canopy)."""
from repas_tpu_torch.canopy.bar import (canny_edges, detect_bar,
                                        detect_rotate_bar,
                                        hough_horizontal_bar)
from repas_tpu_torch.canopy.segment import (apply_green_mask,
                                            green_seed_mask,
                                            refine_plant_mask)
from repas_tpu_torch.canopy.height import CanopyResult, measure_plant_height

__all__ = [
    "canny_edges", "hough_horizontal_bar", "detect_rotate_bar", "detect_bar",
    "green_seed_mask", "refine_plant_mask", "apply_green_mask",
    "measure_plant_height", "CanopyResult",
]
