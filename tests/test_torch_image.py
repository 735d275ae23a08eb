"""Image kernels of the port against the JAX package, on the CPU.

Tolerance: exact, except where stated. The port evaluates the same f32
operations in the same order (the 2x2 decimation sum in row-major order,
0.299r+0.587g+0.114b), and the bilinear sampler's bf16 products are
exact in f32. CLAHE is exact too: its cumsum follows XLA's blocked order
and its interpolation XLA's fused multiply-adds (both probed). Two
stated tolerances: ``gaussian_blur`` within 1e-4 gray (XLA's CPU
convolution sums the taps in an order of its own; measured 4.6e-5), and
``gamma_lut`` within one f32 ulp (XLA's pow and torch's differ by one
ulp on about 1 % of inputs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels import image as J  # noqa: E402
from repas_tpu_torch.kernels import image as T  # noqa: E402

SHAPES = [(2, 48, 64), (1, 37, 53)]


def _rgb(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape + (3,)).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_and_gray_exact(shape):
    rgb = _rgb(shape, 0)
    pj = np.asarray(jax.vmap(J.pack_rgb_u32)(jnp.asarray(rgb)))
    pt = T.pack_rgb_u32(torch.from_numpy(rgb))
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy().astype(np.int64),
                                  pj.astype(np.int64))
    gj = np.asarray(jax.vmap(J.gray_from_u32)(jnp.asarray(pj)))
    np.testing.assert_array_equal(T.gray_from_u32(pt).numpy(), gj)
    np.testing.assert_array_equal(
        T.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
        np.asarray(jax.vmap(J.rgb_to_gray)(jnp.asarray(rgb))))


@pytest.mark.parametrize("shape", [(2, 36, 52), (1, 37, 53), (1, 90, 160)])
def test_decimate_exact(shape):
    # XLA's CPU reduce_window sums 2x2 windows row-major at these shapes
    # and at the pipeline's (720x1280 and its halvings), but pairwise,
    # (a+b)+(c+d), at 48x64; the port follows the row-major order
    rng = np.random.default_rng(1)
    gray = (rng.random(shape) * 255).astype(np.float32)
    ref = np.asarray(jax.vmap(J.decimate)(jnp.asarray(gray)))
    np.testing.assert_array_equal(T.decimate(torch.from_numpy(gray)).numpy(),
                                  ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", [4, 3])
def test_adaptive_threshold_exact(shape, tile):
    rng = np.random.default_rng(2)
    gray = (rng.random(shape) * 255).astype(np.float32)
    gray[:, : shape[1] // 2] *= 0.02          # a low-contrast region
    bj, aj = jax.vmap(lambda g: J.adaptive_threshold(g, tile=tile))(
        jnp.asarray(gray))
    bt, at = T.adaptive_threshold(torch.from_numpy(gray), tile=tile)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert at.numpy().any() and (~at.numpy()).any()


def test_bilinear_sample_patch_exact():
    rng = np.random.default_rng(3)
    patch = (rng.random((3, 40, 56)) * 255).astype(np.float32)
    # coordinates inside, on and beyond the patch edges (clamped)
    uv = (rng.random((3, 7, 9, 2)) * np.array([60, 44]) - 2).astype(
        np.float32)
    uv[:, 0, 0] = [10.0, 12.0]                # integer sample point
    ref = np.asarray(jax.vmap(J.bilinear_sample_patch)(jnp.asarray(patch),
                                                       jnp.asarray(uv)))
    got = T.bilinear_sample_patch(torch.from_numpy(patch),
                                  torch.from_numpy(uv)).numpy()
    assert got.shape == (3, 7, 9)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(720, 1280), (256, 256), (360, 480)])
def test_clahe_exact(shape):
    """720x1280 and 256x256 take the reference's quarter-tile einsum
    branch, 360x480 (odd tiles) its gather branch; one gather formula in
    the port covers both."""
    rng = np.random.default_rng(4)
    gray = (rng.random(shape) * 300 - 20).astype(np.float32)   # clipped
    gray[: shape[0] // 3] = 235.0                               # flat tiles
    ref = np.asarray(jax.jit(J.clahe)(jnp.asarray(gray)))
    np.testing.assert_array_equal(T.clahe(torch.from_numpy(gray)).numpy(),
                                  ref)


def test_clahe_batched_and_odd_grid():
    """Leading batch dims, and an image that is not a multiple of the
    tile grid (the remainder band is still transformed)."""
    rng = np.random.default_rng(5)
    gray = (rng.random((2, 100, 130)) * 255).astype(np.float32)
    got = T.clahe(torch.from_numpy(gray)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jax.jit(J.clahe)(jnp.asarray(gray[b]))))


@pytest.mark.parametrize("sigma", [1.0, 0.8])
def test_gaussian_blur(sigma):
    rng = np.random.default_rng(6)
    gray = (rng.random((2, 90, 160)) * 255).astype(np.float32)
    got = T.gaussian_blur(torch.from_numpy(gray), sigma).numpy()
    for b in range(2):
        ref = np.asarray(jax.jit(lambda g: J.gaussian_blur(g, sigma))(
            jnp.asarray(gray[b])))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-4)
    k = T._gaussian_kernel1d(sigma, max(1, int(3 * sigma + 0.5)))
    np.testing.assert_array_equal(
        k.numpy(), np.asarray(J._gaussian_kernel1d(
            sigma, max(1, int(3 * sigma + 0.5)))))


@pytest.mark.parametrize("gamma", [0.7, 3.0])
def test_gamma_lut(gamma):
    rng = np.random.default_rng(7)
    img = (rng.random((3, 40, 50)) * 300 - 20).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: J.gamma_lut(a, gamma))(
        jnp.asarray(img)))
    np.testing.assert_array_max_ulp(
        T.gamma_lut(torch.from_numpy(img), gamma).numpy(), ref, 1)
