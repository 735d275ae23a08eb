"""repas_tpu_torch — PyTorch + CUDA port of the repas_tpu RGB-D pipeline.

Port of ``repas_tpu/__init__.py``. The JAX package ``repas_tpu`` stays the
reference; this package mirrors its layout and imports torch and numpy,
never jax and nothing from ``repas_tpu``:

  core/     config tree, precision policy, SO(3) helpers, device rule
  kernels/  image ops, CCL, patch extraction, point cloud, Brown-Conrady
            projection, depth-to-color alignment, YUV decoding, and the
            hand-written Hopper kernels (``kernels/csrc``) that replace
            the reference's Pallas kernels
  detect/   tag36h11 codebook, synthetic renderer, batched detector,
            robust retry ladder
  pose/     IPPE-square + LM PnP (and its best corner order), the
            detector's homography pose, SQPnP, depth correction,
            multi-tag fusion, tag bundles, register-then-track streaming
  pipeline  ``process_frames``: detect -> PnP -> fusion -> point cloud,
            for an undistorted or a calibrated camera

Entry points that take tensors run where their inputs lie. Entry points
that take host data (``pose.track.TagTracker``, the YUV formats of
``kernels.color.frame_to_rgb``) run on the card unless given ``device``,
and raise without one (``core/device.py``).
"""

__version__ = "0.1.0"

from repas_tpu_torch.core.precision import set_precision_policy

set_precision_policy()
