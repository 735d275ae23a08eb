"""Kernel B3's plain version, the XLA-form cloud and the depth median
against the JAX package on the CPU.

Tolerances: the port computes B3 with the reference Pallas kernel's
formula ((u-cx)*z*(1/fx)) while the JAX CPU path runs the XLA fallback
((u-cx)/fx*z), so x and y agree to <= 2 ulp: rtol 1e-6 (atol 1e-9 for the
exact zeros at u = cx). z, colours, rgbd_to_pointcloud and the median
are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels import image as JI  # noqa: E402
from repas_tpu.kernels import pointcloud as J  # noqa: E402
from repas_tpu_torch.kernels import image as TI  # noqa: E402
from repas_tpu_torch.kernels import pointcloud as T  # noqa: E402

K = np.array([[412.5, 0, 161.25], [0, 410.0, 95.5], [0, 0, 1]], np.float32)


def _frame(seed, shape=(2, 48, 80)):
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, 3000, shape).astype(np.uint16)
    depth[:, :5, :7] = 0                      # holes
    rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    return depth, rgb


@pytest.mark.parametrize("packed", [True, False])
def test_fused_pointcloud_plain_vs_reference(packed):
    depth, rgb = _frame(0)
    ref = np.asarray(jax.vmap(lambda d, c: J.fused_pointcloud(
        d, JI.pack_rgb_u32(c) if packed else c, K, scale=0.001))(
        jnp.asarray(depth), jnp.asarray(rgb)))
    t_rgb = torch.from_numpy(rgb)
    got = T.fused_pointcloud(torch.from_numpy(depth),
                             TI.pack_rgb_u32(t_rgb) if packed else t_rgb,
                             torch.from_numpy(K), scale=0.001).numpy()
    assert got.shape == ref.shape == (2, 6, 48 * 80)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got[:, 2:], ref[:, 2:])


def test_depth_to_meters_and_rows_exact():
    depth, rgb = _frame(1)
    dm = T.depth_to_meters(torch.from_numpy(depth), 0.001).numpy()
    np.testing.assert_array_equal(
        dm, np.asarray(J.depth_to_meters(jnp.asarray(depth), 0.001)))
    pc = torch.arange(12.0).reshape(1, 6, 2)
    np.testing.assert_array_equal(T.xyzrgb_rows(pc)[0].numpy(),
                                  np.asarray(J.xyzrgb_rows(
                                      jnp.asarray(pc[0].numpy()))))


def test_rgbd_to_pointcloud_exact():
    depth, rgb = _frame(2)
    dm = depth.astype(np.float32) * np.float32(0.001)
    ref = jax.vmap(lambda c, d: J.rgbd_to_pointcloud(c, d, K))(
        jnp.asarray(rgb), jnp.asarray(dm))
    got = T.rgbd_to_pointcloud(torch.from_numpy(rgb), torch.from_numpy(dm),
                               torch.from_numpy(K))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("win", [5, 11])
def test_median_depth_window_exact(win):
    rng = np.random.default_rng(3)
    dm = (rng.random((2, 40, 60)) * 3).astype(np.float32)
    dm[0, 10:20, 10:30] = 0.0                  # a hole: fewer valid
    dm[1, 5:8, 5:8] = np.nan
    dm[1, 30:, 40:] = 0.0                      # all invalid -> 0
    u = np.array([[0, 20, 59, 15, 25], [6, 50, 59, 33, 0]], np.int32)
    v = np.array([[0, 15, 39, 12, 14], [6, 35, 39, 20, 39]], np.int32)
    ref = np.stack([np.asarray(jax.vmap(
        lambda uu, vv: J.median_depth_window(jnp.asarray(dm[b]), uu, vv,
                                             win=win))(
        jnp.asarray(u[b]), jnp.asarray(v[b]))) for b in range(2)])
    got = T.median_depth_window(torch.from_numpy(dm), torch.from_numpy(u),
                                torch.from_numpy(v), win=win).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[1, 2] == 0.0
