"""The canopy and calibration image ops of ``repas_tpu_torch.kernels.image``
against ``repas_tpu.kernels.image`` on the CPU.

Each input comes from a numpy seed and goes through the JAX function
(jitted, as its callers run it) and the port's. Tolerances, with what
was measured (jax 0.9.0, torch 2.13 CPU):
- ``sobel``, ``dilate``, ``erode``, ``morph_open``, ``morph_close`` (sizes
  3, 7, 9, odd image shapes), ``_pool2d``: exact;
- ``gaussian_blur`` at 3, 5 and 7 taps: exact (XLA sums adjacent pairs,
  then the pairs in sequence); at 11 taps within 1e-4 gray (measured
  7.6e-5; XLA's order there is not reproduced, ROADMAP C);
- ``bilinear_sample`` jitted (as ``refine_corners_subpix`` runs it):
  exact, XLA's FMA contraction of the blend reproduced; ``warp_affine``
  called eagerly (as ``detect_rotate_bar`` calls it, so the reference's
  blend is not contracted): within 1e-4 gray (measured below 3.1e-5);
- ``get_rotation_matrix_2d`` called eagerly (as ``detect_bar`` calls it):
  within one f32 ulp (XLA's f32 sin rounds otherwise than float64's in
  2.3 % of angles; exact at the tested angles), ``invert_affine`` and
  ``transform_points_2d`` exact;
- ``rgb_to_hsv_cv`` on all 256^3 RGB colours and ``hsv_in_range``: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels import image as JI  # noqa: E402
from repas_tpu_torch.kernels import image as TI  # noqa: E402


def _img(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 53), (120, 160)])
def test_sobel_exact(shape):
    img = _img(shape)
    gj = jax.jit(JI.sobel)(jnp.asarray(img))
    gt = TI.sobel(torch.from_numpy(img))
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("size", [3, 7, 9])
@pytest.mark.parametrize("op", ["dilate", "erode", "morph_open",
                                "morph_close"])
def test_morphology_exact(op, size):
    img = _img((37, 53), seed=size)
    binary = img > 128
    for x in (img, binary):
        j = jax.jit(getattr(JI, op), static_argnums=1)(jnp.asarray(x), size)
        t = getattr(TI, op)(torch.from_numpy(x), size)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_pool2d_exact():
    img = jnp.asarray(_img((36, 52), seed=3))
    for op, jop, init in (("max", jax.lax.max, -jnp.inf),
                          ("min", jax.lax.min, jnp.inf)):
        j = JI._pool2d(img, 4, jop, init)
        t = TI._pool2d(torch.from_numpy(np.asarray(img)), 4, op)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("sigma,radius,tol", [(0.8, 1, 0.0), (1.1, 2, 0.0),
                                              (1.0, None, 0.0),
                                              (1.5, None, 1e-4)])
def test_gaussian_blur_xla_order(sigma, radius, tol):
    img = _img((61, 83), seed=4)
    j = np.asarray(jax.jit(lambda x: JI.gaussian_blur(x, sigma, radius))(
        jnp.asarray(img)))
    t = TI.gaussian_blur(torch.from_numpy(img), sigma, radius).numpy()
    if tol == 0.0:
        np.testing.assert_array_equal(j, t)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def test_bilinear_sample_exact():
    rng = np.random.default_rng(5)
    img = _img((37, 53), seed=5)
    uv = (rng.random((4000, 2)) * [60, 45] - 5).astype(np.float32)
    j = jax.jit(JI.bilinear_sample)(jnp.asarray(img), jnp.asarray(uv))
    t = TI.bilinear_sample(torch.from_numpy(img), torch.from_numpy(uv))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("angle", [0.0, 6.0, -4.0, 17.3, -11.7])
def test_affine_helpers(angle):
    center = (320, 180)
    Mj = np.asarray(JI.get_rotation_matrix_2d(center, jnp.float32(angle)))
    Mt = TI.get_rotation_matrix_2d(center, torch.tensor(angle)).numpy()
    np.testing.assert_array_max_ulp(Mt, Mj, maxulp=1)
    np.testing.assert_array_equal(Mt, Mj)
    M = torch.from_numpy(Mj.copy())
    np.testing.assert_array_equal(
        TI.invert_affine(M).numpy(),
        np.asarray(jax.jit(JI.invert_affine)(jnp.asarray(Mj))))
    pts = np.random.default_rng(6).uniform(0, 600, (300, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TI.transform_points_2d(M, torch.from_numpy(pts)).numpy(),
        np.asarray(jax.jit(JI.transform_points_2d)(jnp.asarray(Mj),
                                                   jnp.asarray(pts))))


def test_invert_affine_random_rotations():
    """The LU inverse's rounding on 400 rotations about a point, both
    pivot orders (|angle| above and below 45 degrees)."""
    rng = np.random.default_rng(7)
    Ms = np.stack([np.asarray(JI.get_rotation_matrix_2d(
        (320, 180), jnp.float32(a))) for a in rng.uniform(-180, 180, 400)])
    j = np.asarray(jax.jit(jax.vmap(JI.invert_affine))(jnp.asarray(Ms)))
    np.testing.assert_array_equal(TI.invert_affine(torch.from_numpy(Ms)
                                                   ).numpy(), j)


@pytest.mark.parametrize("channels", [1, 3])
def test_warp_affine(channels):
    rng = np.random.default_rng(8)
    shape = (40, 60) if channels == 1 else (40, 60, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    M = np.asarray(JI.get_rotation_matrix_2d((30, 20), jnp.float32(7.3)))
    j = JI.warp_affine(jnp.asarray(img).astype(jnp.float32), jnp.asarray(M),
                       border_value=255.0)
    t = TI.warp_affine(torch.from_numpy(img).float(),
                       torch.from_numpy(M.copy()), border_value=255.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)


def test_hsv_every_rgb_colour():
    allc = np.arange(256 ** 3, dtype=np.int64)
    rgb = np.stack([allc >> 16, (allc >> 8) & 255, allc & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    j = np.asarray(jax.jit(JI.rgb_to_hsv_cv)(jnp.asarray(rgb)))
    t = TI.rgb_to_hsv_cv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(t, j)
    lo, hi = (35, 40, 40), (85, 255, 255)
    np.testing.assert_array_equal(
        TI.hsv_in_range(torch.from_numpy(t), lo, hi).numpy(),
        np.asarray(jax.jit(lambda x: JI.hsv_in_range(x, lo, hi))(j)))
