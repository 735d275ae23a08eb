"""Depth-to-color alignment and the YUV decoders of the port against the
JAX package.

Tolerances:
  * align_depth_to_color: a pixel lands on floor(u), floor(v) of its
    projection, and XLA's fused multiply-adds can move a projection that
    sits within an ulp of an integer to the other side. A color pixel
    whose every candidate source pixel projects more than 1e-3 px (in
    float64) from an integer boundary, so that both backends pick the
    same winning source pixel, must be exactly equal; the others (the
    footprints of the ambiguous sources, widened by the 3x3 hole fill)
    may differ, and at most 1e-4 of all pixels may (measured 8 of 921,600
    under a 1.15 degree rotation at 720p, 0 on the scenes below);
  * nv12_to_rgb, yuyv_to_rgb: at most one level, on at most 0.05 % of the
    values: XLA contracts round(1.164 y + 1.596 v) into an FMA, which
    flips values that sit at .5 (measured 0.008 % and 0.011 %).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels.align import align_depth_to_color as ref_align  # noqa
from repas_tpu.kernels import color as JC  # noqa: E402
from repas_tpu_torch.kernels import color as TC  # noqa: E402
from repas_tpu_torch.kernels.align import align_depth_to_color  # noqa: E402

K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]], np.float32)


def _rot_y(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


def _ambiguous(depth, Kd, Kc, R, t, shape):
    """Color pixels whose value may depend on the backend's rounding:
    2x2 footprints of source pixels projecting within 1e-3 px of an
    integer column or row (float64), dilated by the 3x3 hole fill."""
    h, w = depth.shape
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    Kd, Kc = Kd.astype(np.float64), Kc.astype(np.float64)
    z = np.where(depth > 0, depth, 1.0).astype(np.float64)  # holes: unused
    p = np.stack([(u - Kd[0, 2]) / Kd[0, 0] * z, (v - Kd[1, 2]) / Kd[1, 1] * z,
                  z], -1) @ R.astype(np.float64).T + t
    uc = Kc[0, 0] * p[..., 0] / p[..., 2] + Kc[0, 2]
    vc = Kc[1, 1] * p[..., 1] / p[..., 2] + Kc[1, 2]
    near = lambda x: np.abs(x - np.round(x)) < 1e-3  # noqa: E731
    amb = (depth > 0) & (near(uc) | near(vc))
    out = np.zeros(shape, bool)
    for x, y in zip(np.floor(uc[amb]).astype(int), np.floor(vc[amb])
                    .astype(int)):
        out[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = True
    return out


CASES = {
    # the JAX package's own scenes (tests/test_kernels.py)
    "identity": (lambda: np.pad(np.full((20, 20), 1.25, np.float32),
                                ((10, 18), (20, 24))),
                 np.eye(3, dtype=np.float32), np.zeros(3, np.float32), True),
    "translated": (lambda: np.full((48, 64), 1.0, np.float32),
                   np.eye(3, dtype=np.float32),
                   np.array([0.1, 0.0, 0.0], np.float32), False),
    # a tilted plane with a box and holes under a small extrinsic
    "plane_box": (None, _rot_y(1.15),
                  np.array([0.032, 0.001, -0.002], np.float32), True),
}


def _plane_box(h, w):
    y, x = np.mgrid[0:h, 0:w]
    d = (0.9 + 0.0004 * x * 640 / w + 0.0002 * y * 576 / h).astype(
        np.float32)
    d[h // 3:2 * h // 3, w * 2 // 5:w * 2 // 3] -= 0.25
    d[::9, ::11] = 0.0
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_align_depth_to_color_vs_reference(case):
    make, R, t, fill = CASES[case]
    if make is None:
        depth = _plane_box(144, 160)
        Kd = np.array([[126.0, 0, 80.1], [0, 126.1, 72.05], [0, 0, 1]],
                      np.float32)
        Kc = np.array([[228.1, 0, 157.2], [0, 227.9, 87.2], [0, 0, 1]],
                      np.float32)
        shape = (180, 320)
    else:
        depth, Kd, Kc, shape = make(), K, K, (48, 64)
    ref = np.asarray(ref_align(jnp.asarray(depth), Kd, Kc, R, t,
                               out_shape=shape, fill_holes=fill))
    got = align_depth_to_color(torch.from_numpy(depth), Kd, Kc, R, t, shape,
                               fill).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    differ = got != ref
    assert differ.mean() <= 1e-4
    amb = _ambiguous(depth, Kd, Kc, R, t, shape)
    np.testing.assert_array_equal(got[~amb], ref[~amb])
    assert (ref > 0).mean() > 0.15
    # batched: the same images at once
    both = align_depth_to_color(torch.from_numpy(np.stack([depth, depth])),
                                Kd, Kc, R, t, shape, fill).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], got)


def test_align_shifts_and_fills_as_reference():
    """The reference test's semantics: identity extrinsics keep the box,
    a 10 cm baseline shifts it by fx * 0.1 / z = 4 px here."""
    depth = np.zeros((48, 64), np.float32)
    depth[10:30, 20:40] = 1.25
    out = align_depth_to_color(torch.from_numpy(depth), K, K, np.eye(3),
                               np.zeros(3), (48, 64)).numpy()
    np.testing.assert_allclose(out[11:29, 21:39], 1.25, atol=1e-5)
    assert out[0, 0] == 0.0
    moved = align_depth_to_color(torch.from_numpy(depth), K, K, np.eye(3),
                                 np.array([0.1, 0, 0]), (48, 64)).numpy()
    assert (moved[11:29, 25:43] == 1.25).all() and (moved[:, :23] == 0).all()


def _yuv_close(got, ref):
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-4


@pytest.mark.parametrize("h,w", [(48, 64), (120, 160)])
def test_nv12_and_yuyv_vs_reference(h, w):
    rng = np.random.default_rng(h)
    nv12 = rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8)
    _yuv_close(TC.nv12_to_rgb(torch.from_numpy(nv12)).numpy(),
               np.asarray(JC.nv12_to_rgb(jnp.asarray(nv12))))
    yuyv = rng.integers(0, 256, (h, w * 2), dtype=np.uint8)
    _yuv_close(TC.yuyv_to_rgb(torch.from_numpy(yuyv)).numpy(),
               np.asarray(JC.yuyv_to_rgb(jnp.asarray(yuyv))))
    for fmt, buf in (("nv12", nv12), ("yuyv", yuyv), ("yuy2", yuyv)):
        _yuv_close(TC.frame_to_rgb(buf.reshape(-1), fmt, w, h, device="cpu"),
                   JC.frame_to_rgb(buf.reshape(-1), fmt, w, h))
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for fmt in ("rgb", "bgr8"):
        np.testing.assert_array_equal(
            TC.frame_to_rgb(rgb.reshape(-1), fmt, w, h),
            JC.frame_to_rgb(rgb.reshape(-1), fmt, w, h))
    with pytest.raises(ValueError):
        TC.frame_to_rgb(rgb, "h264", w, h)


def test_frame_to_rgb_defaults_to_the_card():
    buf = np.full((12, 8), 128, np.uint8)
    if torch.cuda.is_available():
        assert TC.frame_to_rgb(buf, "nv12", 8, 8).shape == (8, 8, 3)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TC.frame_to_rgb(buf, "nv12", 8, 8)
