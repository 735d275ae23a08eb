"""The card's peaks and the bytes and operations a kernel call must move
or compute, from its shapes alone.

Frozen from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``,
``INT32_OPS_PER_S``, ``CCL_OPS_PER_PIXEL_ROUND``, ``B3_OPS_PER_POINT``,
``bound_of``, ``ccl_cost``, ``check_b3``'s bytes), so that the
benchmark's rooflines stay what they are when the program changes.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: device
# memory, and float32 outside the tensor cores (an FMA counts two)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# not published: Hopper's SM has half as many INT32 lanes as FP32 lanes
# and an integer min is one operation, so a quarter of the f32 FLOP rate
INT32_OPS_PER_S = F32_OPS_PER_S / 4
# int32 operations per pixel per CCL round: four scan directions of
# (min, select), the separable 3x3 min (four mins), the background select
CCL_OPS_PER_PIXEL_ROUND = 13
# f32 operations per point of B3: z, x and y (7), three colour
# conversions and scalings (6), the z > 0 select
B3_OPS_PER_POINT = 14


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least seconds the card could take: the larger of the bytes
    over the memory rate and the operations over their type's rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def ccl_bound_s(pixels: int, rounds: int) -> float:
    """B1 (``ccl_band``) on a mask of `pixels`: the uint8 mask read once,
    the int32 labels written once, 13 int32 operations a pixel a round."""
    return bound_s(5 * pixels, CCL_OPS_PER_PIXEL_ROUND * rounds * pixels,
                   INT32_OPS_PER_S)


def pointcloud_bound_s(pixels: int) -> float:
    """B3 (``pointcloud``) on `pixels`: u16 depth and the packed int32
    colour read once, six float32 planes written once."""
    return bound_s(pixels * (2 + 4 + 6 * 4), B3_OPS_PER_POINT * pixels,
                   F32_OPS_PER_S)
