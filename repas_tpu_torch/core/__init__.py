"""Config tree, precision policy and SO(3) helpers (port of repas_tpu/core)."""
