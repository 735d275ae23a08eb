"""repas_tpu_torch — PyTorch + CUDA port of the repas_tpu RGB-D pipeline.

Port of ``repas_tpu/__init__.py``. The JAX package ``repas_tpu`` stays the
reference; this package mirrors its layout and imports torch and numpy,
never jax and nothing from ``repas_tpu``:

  core/     config tree, precision policy, SO(3) helpers
  kernels/  image ops, CCL, patch extraction, point cloud, and the
            hand-written Hopper kernels (``kernels/csrc``) that replace
            the reference's Pallas kernels
  detect/   tag36h11 codebook, synthetic renderer, batched detector,
            robust retry ladder
  pose/     IPPE-square + LM PnP (and its best corner order), depth
            correction, multi-tag fusion
  pipeline  ``process_frames``: detect -> PnP -> fusion -> point cloud

Every entry point takes its device from its input tensors.
"""

__version__ = "0.1.0"

from repas_tpu_torch.core.precision import set_precision_policy

set_precision_policy()
