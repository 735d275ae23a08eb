"""The port's tag-anchored crop (``cloud/crop.py``) and masked cloud
generation (``cloud/generate.py``) against the JAX package on the CPU.

Crop: masks equal, box corners and AABB within 1e-6 m. Generation on a
40x48 frame (1,920 points, fewer than the outlier filter's 2,048-point
sample and the normals' 4,096, so both draw every point, in whatever
order, and the sampler's stream drops out): valid masks equal, points
and colours within 1e-6, normals within 1e-4 per component except on
grazing neighbourhoods: three neighbours, nearly collinear, whose plane
contains the ray to the camera (|cos| < 1e-3), so rounding decides the
sign and the eigenvector; those are at most 1 % of the valid points
(measured 6 of 1,439 after the 12 mm voxel filter).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import crop as JC, generate as JG  # noqa: E402
from repas_tpu.core.config import CropConfig as JCropConfig  # noqa: E402
from repas_tpu.core.transforms import rodrigues  # noqa: E402
from repas_tpu_torch.cloud import crop as TC, generate as TG  # noqa: E402
from repas_tpu_torch.core.config import CropConfig  # noqa: E402


@pytest.mark.parametrize("offsets", [(0.1,) * 6 + (0.0,),
                                     (0.2, 0.05, 0.1, 0.3, 0.02, 0.15, 0.01)])
def test_tag_frame_aabb_crop_matches_reference(offsets):
    names = ("dx_front", "dx_back", "dy_front", "dy_back", "dz_front",
             "dz_back", "pad_m")
    kw = dict(zip(names, offsets))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.4, 0.4, (5000, 3)).astype(np.float32)
    pts[:, 2] += 0.6
    mask = rng.random(5000) > 0.1
    R = np.asarray(rodrigues(jnp.asarray(np.array([0.3, -0.2, 0.5],
                                                  np.float32))))
    t = np.array([0.02, -0.03, 0.6], np.float32)
    ref = JC.tag_frame_aabb_crop(jnp.asarray(pts), jnp.asarray(mask),
                                 jnp.asarray(R), jnp.asarray(t),
                                 JCropConfig(**kw))
    got = TC.tag_frame_aabb_crop(torch.from_numpy(pts),
                                 torch.from_numpy(mask), R, t,
                                 CropConfig(**kw))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert 100 < int(got[0].sum()) < 4500
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    inside = TC.aabb_mask(torch.from_numpy(pts), got[1], got[2])
    np.testing.assert_array_equal(inside.numpy(), np.asarray(
        JC.aabb_mask(jnp.asarray(pts), ref[1], ref[2])))


def _frame(seed=0, h=40, w=48):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    depth = (0.8 + 0.05 * np.sin(x / 7.0) + 0.03 * np.cos(y / 5.0)
             + rng.normal(0, 0.001, (h, w))).astype(np.float32)
    depth[3, 5] = 0.0                                   # holes
    depth[10, 40] = np.nan
    depth[20, 20] = 1.3                                 # outliers
    depth[30, 7] = 0.45
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = np.ones((h, w), np.uint8)
    mask[:, :4] = 0
    K = np.array([[60.0, 0, 24.0], [0, 60.0, 20.0], [0, 0, 1]], np.float32)
    return rgb, depth, mask, K


@pytest.mark.parametrize("voxel,outlier_nb,with_normals",
                         [(0.0, 0, False), (0.0, 20, True),
                          (0.012, 8, True)])
def test_create_masked_pointcloud_matches_reference(voxel, outlier_nb,
                                                    with_normals):
    rgb, depth, mask, K = _frame()
    ref = JG.create_masked_pointcloud(jnp.asarray(rgb), jnp.asarray(depth),
                                      K, mask=jnp.asarray(mask), voxel=voxel,
                                      outlier_nb=outlier_nb,
                                      with_normals=with_normals)
    got = TG.create_masked_pointcloud(torch.from_numpy(rgb),
                                      torch.from_numpy(depth), K,
                                      mask=torch.from_numpy(mask),
                                      voxel=voxel, outlier_nb=outlier_nb,
                                      with_normals=with_normals)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 200 < int(got.valid.sum()) < 1920
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.colors.numpy(), np.asarray(ref.colors),
                               rtol=0, atol=1e-6)
    gn, rn = got.normals.numpy(), np.asarray(ref.normals)
    pts = np.asarray(ref.points)
    cos = np.abs((rn * pts).sum(1)) / np.maximum(np.linalg.norm(pts, axis=1),
                                                 1e-9)
    off = np.abs(gn - rn).max(axis=1) > 1e-4
    assert (cos[off] < 1e-3).all(), cos[off]
    assert off.sum() <= 0.01 * int(got.valid.sum())
    if outlier_nb:
        flat = np.flatnonzero(~np.asarray(ref.valid))
        assert 20 * 48 + 20 in flat or voxel       # the outlier went
