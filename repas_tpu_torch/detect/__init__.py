"""tag36h11 codebook, synthetic renderer and batched detector (port of
repas_tpu/detect)."""
