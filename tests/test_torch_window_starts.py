"""Window starts follow ``jax.lax.dynamic_slice``'s rule in the port's
window functions (a negative start has the dimension added, then every
start is clamped so the window fits), held exactly against the JAX
package: ``kernels/image.py::extract_patches``,
``extract_patches_pyramid`` in its degraded (exact-window) and aligned
geometries, and B6's plain version against the measurement tool's
``dynamic_slice`` yardstick. Then the kernel each window copy launches,
named from the geometry alone (``window_copy_path``), and the TMA copy's
plan against TMA's rules.

Tolerance: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels import image as JI, patch_extract as JP  # noqa: E402
from repas_tpu_torch.kernels import image as TI  # noqa: E402
from repas_tpu_torch.kernels import patch_extract as TP  # noqa: E402


def _bf16(rng, shape):
    """A bf16 pyramid as the JAX array and its torch twin (same bits)."""
    j = jnp.asarray(rng.random(shape).astype(np.float32) * 255).astype(
        jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(
        torch.bfloat16)
    return j, t


def test_slice_start_matches_dynamic_slice():
    # a (3,4) slice of a 20x30 array: (-5,-7) reads from (15,23), (-1,-1)
    # from (17,26), (-25,-40) from (0,0), (30,40) from (17,26)
    a = np.arange(600, dtype=np.int32).reshape(20, 30)
    for y, x in [(-5, -7), (-1, -1), (-25, -40), (30, 40), (4, 5)]:
        ref = np.asarray(jax.lax.dynamic_slice(jnp.asarray(a), (y, x),
                                               (3, 4)))
        sy = int(TP.slice_start(torch.tensor(y), 20, 3))
        sx = int(TP.slice_start(torch.tensor(x), 30, 4))
        assert np.array_equal(a[sy:sy + 3, sx:sx + 4], ref)


def test_extract_patches_negative_and_edge_starts():
    rng = np.random.default_rng(11)
    img = rng.random((36, 52)).astype(np.float32)
    starts = np.array([[-1, -1], [-9, -4], [-52, -36], [-80, -90],
                       [0, 0], [40, 30], [51, 35], [200, 100], [-3, 20],
                       [17, -30]], np.int32)
    a = np.asarray(JI.extract_patches(jnp.asarray(img), jnp.asarray(starts),
                                      (10, 14)))
    b = TI.extract_patches(torch.from_numpy(img), torch.from_numpy(starts),
                           (10, 14)).numpy()
    assert np.array_equal(a, b)


@pytest.mark.parametrize("shape,ph,pw,aligned", [
    ((1, 272, 256), 192, 192, False),    # the tracker's degraded geometry
    ((1, 416, 640), 192, 192, True),     # the aligned scheme
])
def test_extract_patches_pyramid_negative_and_edge_starts(shape, ph, pw,
                                                          aligned):
    rng = np.random.default_rng(12)
    pj, pt = _bf16(rng, shape)
    hp, w = shape[1:]
    y0 = np.array([[-1, -50, -hp, 0, hp - ph, hp, 3 * hp, 17]], np.int32)
    x0 = np.array([[-7, -1, 5, -w - 9, w - pw, w + 3, 1, -130]], np.int32)
    assert TP.aligned_ok(shape, ph, pw) == aligned
    rj, ayj, axj = jax.vmap(
        lambda p, y, x: JP.extract_patches_pyramid(p, y, x, ph, pw))(
        pj, jnp.asarray(y0), jnp.asarray(x0))
    rt, ayt, axt = TP.extract_patches_pyramid(
        pt, torch.from_numpy(y0), torch.from_numpy(x0), ph, pw)
    assert np.array_equal(rt.view(torch.int16).numpy(),
                          np.asarray(rj).view(np.int16))
    assert np.array_equal(ayt.numpy(), np.asarray(ayj))
    assert np.array_equal(axt.numpy(), np.asarray(axj))


def test_b6_plain_matches_dynamic_slice_yardstick_at_negative_starts():
    rng = np.random.default_rng(13)
    pj, pt = _bf16(rng, (2, 400, 512))
    st = np.array([[[-1, -1], [-100, -3], [-512, -400], [-900, 17],
                    [320, 208], [330, 220], [5, -250], [-192, -192]],
                   [[0, 0], [-321, -209], [100, 100], [-5, 399],
                    [511, -1], [-2, 0], [1000, -1000], [7, 9]]], np.int32)
    # the tool's yardstick: vmapped dynamic_slice at [x, y] starts
    fx = jax.vmap(lambda pp, ss: jax.vmap(lambda s1: jax.lax.dynamic_slice(
        pp, (s1[1], s1[0]), (192, 192)))(ss))
    ref = np.asarray(fx(pj, jnp.asarray(st))).view(np.int16)
    got = TP.extract_windows_exact(pt, torch.from_numpy(st), 192, 192)
    assert np.array_equal(got.view(torch.int16).numpy(), ref)


@pytest.mark.parametrize("shape,elem,ah,aw,x_align,path", [
    ((16, 1536, 1280), 2, 208, 384, 128, "vector"),   # B2's main path
    ((16, 1512, 1280), 4, 200, 384, 128, "vector"),   # B5 f32
    ((1, 480, 256), 2, 192, 192, 1, "tma"),           # the tracker's B2
    ((16, 1520, 1280), 2, 192, 192, 1, "tma"),        # B6
    ((16, 1520, 1280), 4, 192, 192, 1, "tma"),        # B6 in f32
    ((2, 300, 640), 2, 100, 264, 1, "tma"),           # column boxes
    ((2, 300, 640), 2, 37, 250, 1, "tma"),            # 500-byte rows
    ((2, 100, 150), 4, 92, 144, 1, "scalar"),         # 600-byte pitch
    ((2, 100, 150), 2, 63, 45, 1, "scalar"),
])
def test_window_copy_path_and_tma_plan(shape, elem, ah, aw, x_align, path):
    assert TP.window_copy_path(shape, elem, ah, aw, x_align) == path
    if path != "tma":
        return
    for B, C in ((shape[0], 48), (1, 16)):
        p = TP.tma_plan(B, C, ah, aw, elem, sm_count=132)
        # a box: bw window columns plus one 16-byte vector of cover
        assert 0 < p.bh <= min(256, ah) and 0 < p.bw + 16 // elem <= 256
        assert (p.bw * elem) % 16 == 0 and p.cols * p.bw >= aw
        assert (p.cols - 1) * p.bw < aw
        assert p.bands == -(-ah // p.bh)
        assert p.tasks == B * C * p.bands * p.cols
        assert 1 <= p.grid <= min(p.tasks, 4 * 132)
        assert p.smem_bytes <= 232448
        assert (p.smem_bytes + 1024) * -(-p.grid // 132) <= 233472
