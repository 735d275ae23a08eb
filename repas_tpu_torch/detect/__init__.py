"""tag36h11 codebook, synthetic renderer and batched detector (port of
repas_tpu/detect)."""
from repas_tpu_torch.detect.tag_families import TAG36H11_CODES, tag_family_bits, rotation_perms
from repas_tpu_torch.detect.detector import (Detections, detect_tags,
                                             detect_tags_batch,
                                             detect_tags_jit)
from repas_tpu_torch.detect.render import render_tag

__all__ = [
    "TAG36H11_CODES", "tag_family_bits", "rotation_perms",
    "Detections", "detect_tags", "detect_tags_batch", "render_tag",
    "detect_tags_jit",
]
