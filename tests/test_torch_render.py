"""The port's splat renderer and HTML viewer (viz/render.py,
viz/html_viewer.py) against the JAX package's.

- ``render_pointcloud``: the z-buffer exactly equal (the port's pass 1
  against a jitted copy of the reference's pass 1, which the reference
  does not return) and the image exactly equal, on a random cloud seen
  from four orbit views and on a fronto-parallel plane where every
  pixel's winners tie. The port writes the reference's camera transform
  as its XLA dot rounds (fma chain), the reference's rgb / 255 as the
  f32 reciprocal multiply, and picks among tied winners the point XLA's
  in-order CPU scatter leaves (the last splat offset's highest index):
  no pixel moved in any view (a first-writer rule differs at all 4,800
  tied pixels).
- ``rasterize_segments``: the image exactly equal (its linspace carries
  jnp.linspace's reciprocal multiply: torch.linspace differs from it in
  126 of 256 samples).
- ``look_at``, ``orbit_views``: host numpy copied, exactly equal.
- ``write_html_viewer``: the file byte-identical, with and without the
  subsampling past max_points.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.viz import html_viewer as JH, render as J  # noqa: E402
from repas_tpu_torch.viz import (look_at, orbit_views,  # noqa: E402
                                 rasterize_segments, render_pointcloud,
                                 write_html_viewer)
from repas_tpu_torch.viz.render import _linspace01, zbuffer  # noqa: E402

K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]], np.float32)
SHAPE = (120, 160)


@functools.partial(jax.jit, static_argnames=("shape", "splat"))
def _ref_zbuffer(xyzrgb, K, R, t, shape, splat=2, z_near=1e-3):
    """Pass 1 of repas_tpu/viz/render.py::render_pointcloud, as written
    there (:44-65)."""
    H, W = shape
    pts = xyzrgb[:, :3]
    K = jnp.asarray(K, jnp.float32)
    cam = pts @ jnp.asarray(R, jnp.float32).T + jnp.asarray(t, jnp.float32)
    z = cam[:, 2]
    valid = z > z_near
    zs = jnp.where(valid, z, 1.0)
    u = (K[0, 0] * cam[:, 0] / zs + K[0, 2]).astype(jnp.int32)
    v = (K[1, 1] * cam[:, 1] / zs + K[1, 2]).astype(jnp.int32)
    zbuf = jnp.full((H, W), jnp.inf, jnp.float32)
    for dv in range(splat):
        for du in range(splat):
            uu, vv = u + du, v + dv
            ok = valid & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            ui, vi = jnp.where(ok, uu, 0), jnp.where(ok, vv, 0)
            zbuf = zbuf.at[vi, ui].min(jnp.where(ok, z, jnp.inf),
                                       mode="drop")
    return zbuf


def _cloud(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * [0.2, 0.15, 0.05] + [0, 0, 0.6]
    pts[:, 2] = np.round(pts[:, 2] * 200) / 200        # equal depths
    cols = rng.integers(0, 256, (n, 3))
    return np.concatenate([pts, cols], 1).astype(np.float32)


def _views(xyzrgb):
    return (J.orbit_views(xyzrgb[:, :3].mean(0), 1.0, n=3)
            + [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))])


@pytest.mark.parametrize("splat", [1, 2, 3])
def test_render_pointcloud_matches_reference(splat):
    xyzrgb = _cloud()
    pt = torch.from_numpy(xyzrgb)
    for R, t in _views(xyzrgb):
        zj = np.asarray(_ref_zbuffer(jnp.asarray(xyzrgb), K, R, t, SHAPE,
                                     splat))
        zt = zbuffer(pt, K, R, t, shape=SHAPE, splat=splat).numpy()
        assert np.array_equal(zj, zt)
        ij = np.asarray(J.render_pointcloud(jnp.asarray(xyzrgb), K, R, t,
                                            shape=SHAPE, splat=splat))
        it = render_pointcloud(pt, K, R, t, shape=SHAPE, splat=splat)
        assert it.dtype == torch.float32 and it.shape == (*SHAPE, 3)
        assert np.array_equal(ij, it.numpy())
        assert (it.numpy() != 1.0).any(axis=-1).mean() > 0.05


@pytest.mark.parametrize("n", [30000, 200000])
def test_render_tied_winners_match_reference(n):
    """A fronto-parallel plane at one depth: every point of a pixel ties;
    the reference keeps the last offset's highest index."""
    rng = np.random.default_rng(n)
    pts = np.stack([rng.uniform(-0.25, 0.25, n), rng.uniform(-0.18, 0.18, n),
                    np.full(n, 0.5)], 1)
    xyzrgb = np.concatenate([pts, rng.uniform(0, 1, (n, 3))],
                            1).astype(np.float32)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    ij = np.asarray(J.render_pointcloud(jnp.asarray(xyzrgb), K, R, t,
                                        shape=(60, 80), background=0.25))
    it = render_pointcloud(torch.from_numpy(xyzrgb), K, R, t, shape=(60, 80),
                           background=0.25).numpy()
    assert np.array_equal(ij, it)


def test_rasterize_segments_matches_reference():
    rng = np.random.default_rng(2)
    segs = rng.uniform(-0.3, 0.3, (40, 2, 3)).astype(np.float32)
    segs[..., 2] += 0.8
    cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    img = rng.uniform(0, 1, (90, 120, 3)).astype(np.float32)
    Kc = np.array([[120.0, 0, 60], [0, 120.0, 45], [0, 0, 1]], np.float32)
    R, t = J.look_at([0.1, -0.2, -0.3], [0, 0, 0.8])
    for samples in (7, 256):
        a = np.asarray(J.rasterize_segments(jnp.asarray(img), segs, cols, Kc,
                                            R, t, samples=samples))
        b = rasterize_segments(torch.from_numpy(img), segs, cols, Kc, R, t,
                               samples=samples).numpy()
        assert np.array_equal(a, b)
        assert (b != img).any(axis=-1).sum() > 100
    for s in (2, 7, 64, 100, 256, 4096):
        assert np.array_equal(np.asarray(jnp.linspace(0.0, 1.0, s)),
                              _linspace01(s, "cpu").numpy())


def test_look_at_and_orbit_views_match_reference():
    for eye, c, up in (([1, 2, 3], [0, 0, 1], (0, 1, 0)),
                       ([0, 5, 0], [0, 0, 0], (0, 1, 0)),      # up || fwd
                       ([0.3, -0.1, -0.5], [0.01, 0.02, 0.6], (0, 0, 1))):
        for x, y in zip(J.look_at(eye, c, up), look_at(eye, c, up)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for (Rj, tj), (Rt, tt) in zip(J.orbit_views([0.1, 0, 0.6], 0.8, 8, 30.0),
                                  orbit_views([0.1, 0, 0.6], 0.8, 8, 30.0)):
        assert np.array_equal(Rj, Rt) and np.array_equal(tj, tt)


@pytest.mark.parametrize("n,colors", [(5000, "float"), (5000, "uint8"),
                                      (1200, None)])
def test_write_html_viewer_byte_identical(tmp_path, n, colors):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = {"float": rng.uniform(0, 1, (n, 3)),
            "uint8": rng.integers(0, 256, (n, 3), dtype=np.uint8),
            None: None}[colors]
    a = JH.write_html_viewer(tmp_path / "a" / "v.html", pts, cols,
                             title="scene", max_points=3000)
    b = write_html_viewer(tmp_path / "b" / "v.html", pts, cols,
                          title="scene", max_points=3000)
    assert a.read_bytes() == b.read_bytes()
