"""PnP, depth correction and multi-tag fusion (port of repas_tpu/pose)."""
