"""Logging helpers (port of repas_tpu/utils; the profiling helpers are not
ported yet)."""
from repas_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger"]
