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
  * decision margin: <= 0.25 gray;
  * candidate outputs (``with_candidates``): scores of tag-shaped
    candidates (reference score >= 100: border, contrast and bits all
    present) within 1e-4 relative, their bboxes within 0.05 px, and the
    best candidate of each frame the same slot; weaker candidates are
    undecoded quads whose bits sit at the threshold (ROADMAP section C),
    so for them only score 0 vs > 0 is compared where both are clear of
    1 (measured: 23.1 vs 13.2 on one such quad);
  * ``quad_sigma`` 0.8 (Gaussian blur first): as the plain detector, the
    blur's taps summed in the port's fixed order (within 1e-4 gray of
    XLA's convolution).
The float tolerances absorb the XLA CPU backend's fused multiply-adds,
which eager torch does not form: sample coordinates differ by an ulp, a
tied gradient peak of the edge refiner can move by an offset step, and
refined corners move by up to a few hundredths of a pixel, the decode
grid's edge samples with them (ROADMAP section C).

The reference runs with the port detector's two departures
(``tests/jax_departures.py``: converged labels, member-only support
points). The JAX package finds and decodes every tag of these frames
too, so every frame is held to that reference under the limits above
(measured: corners at most 0.040 px, bboxes 0.040 px, margin 0.044
gray).
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
from jax_departures import jax_detector_departures  # noqa: E402,F401
from torch_threads import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread",
                                     "jax_detector_departures")

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


@pytest.mark.parametrize("sigma", [0.0, 0.8])
def test_detect_tags_with_candidates_vs_reference(sigma):
    from repas_tpu.core.config import DetectorConfig as JCfg
    from repas_tpu_torch.core.config import DetectorConfig as TCfg

    rgbs = np.stack([scene(tags, i) for i, tags in enumerate(FRAMES)])
    det_r, bbox_r, score_r = jax.vmap(lambda x: JD.detect_tags(
        x, JCfg(quad_sigma=sigma), with_candidates=True))(jnp.asarray(rgbs))
    det, bbox, score = TD.detect_tags(torch.from_numpy(rgbs),
                                      TCfg(quad_sigma=sigma),
                                      with_candidates=True)
    for name in ("ids", "valid"):
        np.testing.assert_array_equal(getattr(det, name).numpy(),
                                      np.asarray(getattr(det_r, name)))
    v = det.valid.numpy()
    assert np.abs(det.corners.numpy()
                  - np.asarray(det_r.corners))[v].max() <= 0.05
    s, sr = score.numpy(), np.asarray(score_r)
    assert score.shape == sr.shape and bbox.shape == bbox_r.shape
    strong = sr >= 100.0
    assert strong.sum() >= 4                   # the four decoded tags
    np.testing.assert_array_equal(s >= 100.0, strong)
    np.testing.assert_allclose(s[strong], sr[strong], rtol=1e-4)
    assert np.abs(bbox.numpy() - np.asarray(bbox_r))[strong].max() <= 0.05
    np.testing.assert_array_equal(np.argmax(s, axis=1), np.argmax(sr, axis=1))
    clear = (np.abs(s) > 1.0) | (s == 0)
    clear &= (np.abs(sr) > 1.0) | (sr == 0)
    np.testing.assert_array_equal((s > 0)[clear], (sr > 0)[clear])
