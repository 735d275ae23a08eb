"""``measure_plant_height`` on one 1280x720 capture, the port against the
JAX package on the CPU (the full-resolution case of
``tests/test_torch_canopy.py``, in a file of its own so that the suite's
workers share the load).

The scene is ``chip_smoke.py``'s canopy capture: a bright bar tilted 6
degrees, a green plant body whose top ends in a 2 px leaf tip, a grey
background, u16 depth with the plant and bar at 1.07 m (depth edges 4 px
outside the colour edges) and the background 2 m behind, 2 mm noise,
bench intrinsics. Tolerances as in test_torch_canopy.py: found, bar_px,
the bar's 3-D point, the angle and the plant mask exact; canopy_px within
1e-4 px, the canopy's 3-D point and the height within 1e-6 m (measured
exact on this scene; 3.1e-5 px at 5.5 degrees).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.canopy import measure_plant_height as j_measure  # noqa: E402
from repas_tpu_torch.canopy import measure_plant_height  # noqa: E402

K = np.array([[912.35, 0, 628.78], [0, 911.78, 348.98], [0, 0, 1.0]],
             np.float32)


def canopy_scene(h=720, w=1280, angle_deg=6.0, z=1.07, seed=0):
    """rgb (h,w,3) u8, depth u16 mm, the tip's pixel and the truth height
    (the bar's top edge at x = w/2 against the tip's top row)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rgb = rng.normal(120, 3, (h, w, 3))
    yb, half = 560.0, 4.0
    yc = yb + np.tan(np.deg2rad(angle_deg)) * (xx - w / 2)
    bar = (np.abs(yy - yc) <= half) & (xx >= 0.05 * w) & (xx <= 0.95 * w)
    rgb[bar] = 235 + rng.normal(0, 3, (bar.sum(), 3))
    cx, cy, ax, ay = 0.5 * w, 330.0, 150.0, 110.0
    body = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 < 1.0
    top = cy - ay
    tip = (np.abs(xx - (cx + 0.5)) <= 1.0) & (yy >= top - 24) & (yy <= top + 2)
    plant = body | tip
    rgb[plant] = [45, 165, 55] + rng.normal(0, 4, (plant.sum(), 3))
    rgb = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    near = plant | bar
    grown = near.copy()
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            grown |= np.roll(np.roll(near, dy, 0), dx, 1)
    depth = np.where(grown, z, z + 2.0) + rng.normal(0, 0.002, (h, w))
    tip_y = float(np.where(plant.any(1))[0][0])
    tip_x = float(np.median(np.where(plant[int(tip_y)])[0]))
    height = (yb - half - 0.5 - tip_y) * z / float(K[1, 1])
    return rgb, np.round(depth * 1000).astype(np.uint16), (tip_x, tip_y), \
        height


def test_measure_plant_height_720p_matches_reference():
    rgb, d16, tip, height = canopy_scene()
    depth = d16.astype(np.float32) / 1000.0
    j = j_measure(jnp.asarray(rgb), jnp.asarray(depth), K)
    t = measure_plant_height(torch.from_numpy(rgb), torch.from_numpy(depth),
                             K)
    for k in j._fields:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    # and the scene's truth: the leaf tip and the height
    assert bool(t.found)
    assert np.abs(t.canopy_px.numpy() - tip).max() <= 1.5
    assert abs(float(t.plant_height_m) - height) < 0.005
