"""The batched detector of the port against the JAX package's detector
(vmapped over the same frames) on rendered 360x640 scenes.

Tolerances:
  * ids, valid, component areas: exact in every slot;
  * hamming: exact in valid slots;
  * corners and centers of valid slots: <= 0.05 px;
  * dead slots hold undecoded candidates in the same slot order (ids,
    valid and areas above), but a slot is meaningful only where valid
    (the Detections contract): a garbage quad's decode bits sit at the
    threshold, and its rotation, hamming and refined corners may differ
    (measured up to 0.8 px and one corner roll);
  * decision margin: <= 0.25 gray.
The float tolerances absorb the XLA CPU backend's fused multiply-adds,
which eager torch does not form: sample coordinates differ by an ulp, a
tied gradient peak of the edge refiner can move by an offset step, and
refined corners move by up to a few hundredths of a pixel, the decode
grid's edge samples with them (ROADMAP section C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.detect import detector as JD  # noqa: E402
from repas_tpu.detect import render as JR  # noqa: E402
from repas_tpu_torch.detect import detector as TD  # noqa: E402
from repas_tpu_torch.detect import render as TR  # noqa: E402
from repas_tpu_torch.kernels import ccl as TC  # noqa: E402

H, W = 360, 640
F = 0.6 * W
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)


def _rot(ax_deg, az_deg):
    ax, az = np.radians(ax_deg), np.radians(az_deg)
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]])
    return Rz @ Rx


def scene(tags, seed, background=180.0):
    """Gray scene with (tag_id, R, t, size_m) tags, noise sigma 2."""
    img = np.full((H, W), background, np.float32)
    for tid, R, t, size in tags:
        g = TR.render_tag_in_scene(tid, R, np.asarray(t), K, size, (H, W),
                                   background=background)
        img = np.where(np.abs(g - background) > 1e-3, g, img)
    rng = np.random.default_rng(seed)
    img = np.clip(img + rng.normal(0, 2.0, img.shape), 0, 255)
    return np.repeat(img[..., None], 3, axis=-1).astype(np.uint8)


FRAMES = [
    [(9, np.eye(3), (0.0, 0.0, 0.45), 0.06)],
    [(9, _rot(0, 180), (-0.1, 0.0, 0.5), 0.05),
     (16, np.eye(3), (0.1, 0.02, 0.6), 0.05)],
    [],                                        # no tag
    [(16, _rot(25, 30), (0.02, -0.03, 0.5), 0.07)],
]


def test_renderer_matches_reference():
    R, t = _rot(20, 10), np.array([0.01, 0.02, 0.4])
    np.testing.assert_array_equal(
        TR.render_tag_in_scene(16, R, t, K, 0.05, (120, 160)),
        JR.render_tag_in_scene(16, R, t, K, 0.05, (120, 160)))
    np.testing.assert_array_equal(TR.render_tag(3), JR.render_tag(3))
    np.testing.assert_array_equal(TR.tag_corner_px(), JR.tag_corner_px())


def test_detect_tags_batch_vs_reference():
    rgbs = np.stack([scene(tags, i) for i, tags in enumerate(FRAMES)])
    ref = jax.vmap(JD.detect_tags)(jnp.asarray(rgbs))
    got = TD.detect_tags(torch.from_numpy(rgbs))
    for name in ("ids", "valid", "areas"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name)
    v = got.valid.numpy()
    np.testing.assert_array_equal(got.hamming.numpy()[v],
                                  np.asarray(ref.hamming)[v])
    ids = got.ids.numpy()
    assert sorted(ids[1][ids[1] >= 0].tolist()) == [9, 16]
    assert (ids[2] == -1).all()
    assert set(ids[0][ids[0] >= 0]) == {9} and set(ids[3][ids[3] >= 0]) == {16}
    cg, cr = got.corners.numpy(), np.asarray(ref.corners)
    assert np.abs(cg - cr)[v].max() <= 0.05
    assert np.abs(got.centers.numpy() - np.asarray(ref.centers))[v].max() \
        <= 0.05
    np.testing.assert_allclose(got.decision_margin.numpy(),
                               np.asarray(ref.decision_margin), atol=0.25)


def test_support_points_exact():
    """Support points (from the same labels, roots and bboxes) are exact:
    integer pixel coordinates through the same masked reductions."""
    rgbs = np.stack([scene(FRAMES[1], 1)])
    gray = torch.from_numpy(rgbs).to(torch.float32).mean(-1)
    from repas_tpu_torch.kernels.image import adaptive_threshold, decimate

    lo = decimate(gray, 2)
    b, a = adaptive_threshold(lo)
    labels = TC.connected_components_plain((~b) & (~a), 5)
    roots, _, _, bbox = TC.top_k_components(
        labels, 16, min_area=16.0, max_area=0.45 * lo.shape[1] * lo.shape[2],
        ring_filter=True, min_side=4.0, return_bbox=True)
    got = TD._support_points(labels, roots, bbox)[0].numpy()
    ref = np.asarray(JD._support_points(jnp.asarray(labels[0].numpy()),
                                        jnp.asarray(roots[0].numpy()),
                                        jnp.asarray(bbox[0].numpy())))
    np.testing.assert_array_equal(got, ref)
    quads_ref = np.asarray(jax.vmap(JD._quad_from_support)(jnp.asarray(ref)))
    np.testing.assert_array_equal(
        TD._quad_from_support(torch.from_numpy(ref)).numpy(), quads_ref)
