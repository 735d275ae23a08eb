"""Logging and profiling helpers (port of repas_tpu/utils)."""
from repas_tpu_torch.utils.logging import get_logger
from repas_tpu_torch.utils.profiling import stage_timer, FpsCounter

__all__ = ["get_logger", "stage_timer", "FpsCounter"]
