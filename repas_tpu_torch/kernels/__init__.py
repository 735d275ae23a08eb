"""Image, CCL, patch-extraction and point-cloud kernels (port of
repas_tpu/kernels). The modules ``ccl_cuda``, ``ccl_tiled``,
``patch_extract`` and ``pointcloud`` launch hand-written CUDA kernels
(``csrc/``) on CUDA tensors and run their plain PyTorch versions on CPU
tensors."""
