"""The canopy-height path of the port (``repas_tpu_torch.canopy``, the
canopy config, ``kernels.pointcloud.masked_median_depth_window``) against
the JAX package on the CPU, on synthetic scenes made from a numpy seed:
``tests/test_canopy.py``'s 240x320 plant scene and tilted-bar scenes with
a thin leaf tip and sensor noise (tests/test_torch_scenes.py).

Tolerances, with what was measured (jax 0.9.0, torch 2.13 CPU):
- ``canny_edges``: equal edge maps (measured: 0 pixels differ on every
  scene here; XLA's atan2 rounds otherwise than torch's in about 12 % of
  gradients, but no gradient here lies within an ulp of a sector edge);
- ``hough_horizontal_bar``: found, angle, endpoints, coverage and length
  exact, also when more edge pixels than ``max_edges`` slots compete
  (the first in index order vote, as ``lax.top_k`` keeps them);
- ``detect_bar``: line and M exact; ``detect_rotate_bar``'s image within
  1e-4 gray (the reference's eager blend is not contracted, the port's
  is; measured 3.1e-5);
- ``_hsv_bins`` on all 256^3 colours, ``green_seed_mask``,
  ``refine_plant_mask`` (no log-ratio sign flipped), the reconstruction,
  ``apply_green_mask`` and ``canopy_level_mark``: exact;
- ``masked_median_depth_window``: exact (odd and even counts);
- ``measure_plant_height``: every field exact (the port reproduces XLA's
  rounding of the 2x2 inverse and of the affine dot; an angle whose f32
  sin XLA rounds otherwise, 2.9 % of random angles, would move M by an
  ulp and canopy_px by about 1e-5 px: none on these scenes, ROADMAP C).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.canopy import bar as JB, segment as JS  # noqa: E402
from repas_tpu.canopy import height as JH  # noqa: E402
from repas_tpu.core import config as JCFG  # noqa: E402
from repas_tpu.kernels import pointcloud as JP  # noqa: E402
from repas_tpu_torch.canopy import bar as TB, segment as TS  # noqa: E402
from repas_tpu_torch.canopy import height as TH  # noqa: E402
from repas_tpu_torch.core import config as TCFG  # noqa: E402
from repas_tpu_torch.kernels import pointcloud as TP  # noqa: E402
from test_torch_scenes import tilted_scene  # noqa: E402

K240 = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1.0]])


def plant_scene():
    """tests/test_canopy.py's 240x320 scene: grey background, bright bar
    at rows 198-202, green elliptical plant."""
    rgb = np.full((240, 320, 3), 120, dtype=np.uint8)
    rgb[198:203, 10:310] = 240
    yy, xx = np.mgrid[0:240, 0:320]
    blob = ((yy - 130) ** 2 / 2500 + (xx - 160) ** 2 / 900) < 1.0
    rgb[blob] = [40, 170, 50]
    return rgb, np.full((240, 320), 0.8, np.float32)


SCENES = {"plant": plant_scene(), "tilt6": tilted_scene(6.0, 1),
          "tilt-9": tilted_scene(-9.0, 2), "tilt3": tilted_scene(3.0, 3)}


def _gray(rgb):
    from repas_tpu_torch.kernels.image import rgb_to_gray
    return rgb_to_gray(torch.from_numpy(rgb)).numpy()


def test_configs_equal_reference():
    assert (dataclasses.asdict(TCFG.CanopyConfig())
            == dataclasses.asdict(JCFG.CanopyConfig()))
    ref = JCFG.PipelineConfig()
    port = TCFG.from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    changed = dataclasses.replace(ref, canopy=dataclasses.replace(
        ref.canopy, proc_decimate=1, green_lo=(30, 70, 20)))
    assert (dataclasses.asdict(TCFG.from_reference(
        dataclasses.asdict(changed)).canopy)
        == dataclasses.asdict(changed.canopy))


@pytest.mark.parametrize("win", [5, 24, 25])
def test_masked_median_depth_window(win):
    rng = np.random.default_rng(win)
    depth = rng.uniform(0.5, 3.0, (60, 80)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    depth[rng.random(depth.shape) < 0.05] = np.nan
    mask = rng.random(depth.shape) < 0.5
    mask[:20, :20] = False                        # an empty window
    us = [0, 5, 40, 79, 3, 60]
    vs = [0, 5, 30, 59, 4, 1]
    got = TP.masked_median_depth_window(
        torch.from_numpy(depth)[None], torch.from_numpy(mask)[None],
        torch.tensor([us]), torch.tensor([vs]), win)[0].numpy()
    want = [float(JP.masked_median_depth_window(
        jnp.asarray(depth), jnp.asarray(mask), u, v, win))
        for u, v in zip(us, vs)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert got[0] == 0.0 and got[4] == 0.0        # no mask pixel there


@pytest.fixture(scope="module")
def edges():
    """Canny edge maps of each scene's gray image, both packages."""
    out = {}
    for name, (rgb, _) in SCENES.items():
        g = _gray(rgb)
        out[name] = (np.asarray(JB.canny_edges(jnp.asarray(g))),
                     TB.canny_edges(torch.from_numpy(g)).numpy())
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_canny_edges_equal(edges, name):
    je, te = edges[name]
    assert je.sum() > 100
    np.testing.assert_array_equal(te, je)


def _line_equal(jl, tl):
    for k in jl._fields:
        np.testing.assert_array_equal(getattr(tl, k).numpy(),
                                      np.asarray(getattr(jl, k)), err_msg=k)


@pytest.mark.parametrize("max_edges", [16384, 256])
@pytest.mark.parametrize("name", list(SCENES))
def test_hough_horizontal_bar_exact(edges, name, max_edges):
    je = edges[name][0]
    assert max_edges == 16384 or je.sum() > max_edges
    jl = JB.hough_horizontal_bar(jnp.asarray(je), threshold=40,
                                 max_edges=max_edges)
    tl = TB.hough_horizontal_bar(torch.from_numpy(je), threshold=40,
                                 max_edges=max_edges)
    assert bool(jl.found) or max_edges == 256
    _line_equal(jl, tl)


def test_hough_other_band_runs():
    """Arguments off the carried table compute theirs (no exactness
    claimed: torch's linspace and sin round otherwise)."""
    e = np.zeros((60, 90), bool)
    e[30, 5:85] = True
    tl = TB.hough_horizontal_bar(torch.from_numpy(e), threshold=20,
                                 max_angle_deg=10.0, n_theta=21)
    assert bool(tl.found) and abs(float(tl.angle_deg)) < 0.5


@pytest.mark.parametrize("name", ["tilt6", "tilt-9"])
def test_detect_bar_and_rotate(name):
    rgb = SCENES[name][0]
    jl, jM = JB.detect_bar(jnp.asarray(rgb), hough_threshold=40)
    tl, tM = TB.detect_bar(torch.from_numpy(rgb), hough_threshold=40)
    _line_equal(jl, tl)
    np.testing.assert_array_equal(tM.numpy(), np.asarray(jM))
    jl2, jM2, jrot = JB.detect_rotate_bar(jnp.asarray(rgb),
                                          hough_threshold=40)
    tl2, tM2, trot = TB.detect_rotate_bar(torch.from_numpy(rgb),
                                          hough_threshold=40)
    _line_equal(jl2, tl2)
    np.testing.assert_allclose(trot.numpy(), np.asarray(jrot), rtol=0,
                               atol=1e-4)


def test_hsv_bins_every_rgb_colour():
    from repas_tpu.kernels.image import rgb_to_hsv_cv as j_hsv
    allc = np.arange(256 ** 3, dtype=np.int64)
    rgb = np.stack([allc >> 16, (allc >> 8) & 255, allc & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    j = np.asarray(jax.jit(lambda x: JS._hsv_bins(j_hsv(x)))(
        jnp.asarray(rgb)))
    from repas_tpu_torch.kernels.image import rgb_to_hsv_cv
    t = TS._hsv_bins(rgb_to_hsv_cv(torch.from_numpy(rgb))).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", list(SCENES))
def test_segmentation_exact(name):
    rgb = SCENES[name][0]
    jr, tr = jnp.asarray(rgb), torch.from_numpy(rgb)
    jseed = JS.green_seed_mask(jr)
    tseed = TS.green_seed_mask(tr)
    np.testing.assert_array_equal(tseed.numpy(), np.asarray(jseed))
    jfg = JS.refine_plant_mask(jr, jseed, iters=5)
    tfg = TS.refine_plant_mask(tr, tseed, iters=5)
    np.testing.assert_array_equal(tfg.numpy(), np.asarray(jfg))
    jp = JS.apply_green_mask(jr, jfg)
    tp = TS.apply_green_mask(tr, tfg)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for got, want in zip(TS.canopy_level_mark(tp), JS.canopy_level_mark(jp)):
        assert int(got) == int(want)
    # geodesic reconstruction from a few seeds into the seed mask
    marker = np.zeros(rgb.shape[:2], bool)
    marker[::37, ::41] = True
    lim = np.asarray(jseed)
    np.testing.assert_array_equal(
        TS._reconstruct_by_dilation(torch.from_numpy(marker),
                                    torch.from_numpy(lim), 4, 7).numpy(),
        np.asarray(JS._reconstruct_by_dilation(jnp.asarray(marker),
                                               jnp.asarray(lim), 4, 7)))


def test_canopy_level_mark_empty():
    m = np.zeros((8, 9), bool)
    assert [int(v) for v in TS.canopy_level_mark(torch.from_numpy(m))] == \
        [int(v) for v in JS.canopy_level_mark(jnp.asarray(m))]


def _result_equal(j, t):
    for k in j._fields:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)


@pytest.mark.parametrize("name", list(SCENES))
def test_measure_plant_height(name):
    rgb, depth = SCENES[name]
    cfg = dict(hough_threshold=40)
    j = JH.measure_plant_height(jnp.asarray(rgb), jnp.asarray(depth), K240,
                                JCFG.CanopyConfig(**cfg))
    t = TH.measure_plant_height(torch.from_numpy(rgb),
                                torch.from_numpy(depth), K240,
                                TCFG.CanopyConfig(**cfg))
    assert bool(t.found)
    _result_equal(j, t)
    if name != "plant":                   # the tip is recovered
        assert abs(float(t.canopy_px[1]) - (0.45 * 240 - 50)) <= 1.5
