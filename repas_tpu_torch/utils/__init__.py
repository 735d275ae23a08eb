"""Logging and profiling helpers (port of repas_tpu/utils)."""
from repas_tpu_torch.utils.logging import get_logger
from repas_tpu_torch.utils.profiling import FpsCounter, span

__all__ = ["get_logger", "FpsCounter", "span"]
