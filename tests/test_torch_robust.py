"""The robust detection ladder of the port against the JAX package, on the
CPU: the merge and ROI helpers, ``detect_tags_robust`` on one image, stage
A's ROI choice and stage B's escalation. The synthetic scenes of
``tests/test_robust_staged.py`` (easy frames plus a blank one, the ROI
escalation pair, the 6-of-8 wave batch, stage B's waves) live here, and
``tests/test_torch_robust_ladder.py`` holds ``detect_tags_robust_staged``
on them against the JAX ladder (a file of its own, so that test workers
that take a file each run the two halves side by side).

Tolerances:
  * ``_merge_by_margin``, ``_top_rois``: exact, ties included (sorts,
    compares and gathers of the same f32 values);
  * ladders: ids and valid exact in every slot; corners and centres of
    valid slots within 0.05 px, the detector's gate (XLA's CPU backend
    contracts multiply-adds into FMAs that eager torch does not form,
    ROADMAP section C), except on the staged scenes: their tags are
    pixel-replicated renders with no blur or noise, so gradient peaks of
    the edge refiner tie across whole plateaus and an ulp moves a peak by
    a whole search step. There the bound is 0.5 px (measured: 0.072 px on
    the 96 px tags, 0.354 px on one corner of three of the 48 px tags;
    ROADMAP section C), while ids and valid stay exact;
  * stage A's ROI choice on frames with more than ``_ROI_Q`` undecoded
    candidates: strong candidates (reference score >= 100) exact in
    choice and order (boxes within 0.05 px, scores within 1e-4 relative);
    weak ones are chosen among the reference's own candidate quads (box
    within 1 px of one of them), but their scores, and so their rank, are
    not the reference's. XLA contracts the refiner's
    sample positions into FMAs, the bf16 hat weights of the matmul
    sampler turn those few ulps into ~1 % of a sample, and on a quad with
    no clear edge the line fit and then the threshold-level decode bits
    move with them (ROADMAP section C; measured: 23.1 vs 13.2 on one
    quad; on this test's 8 frames 24 of the 32 ROIs and the first ROI of
    every frame are the reference's, 8 ROIs in 4 frames are not).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.core.config import DetectorConfig as JConfig  # noqa: E402
from repas_tpu.detect import robust as JR  # noqa: E402
from repas_tpu.detect.detector import Detections as JDet  # noqa: E402
from repas_tpu_torch.core.config import DetectorConfig  # noqa: E402
from repas_tpu_torch.detect import robust as TR  # noqa: E402
from repas_tpu_torch.detect.detector import Detections  # noqa: E402
from repas_tpu_torch.detect.render import (render_tag,  # noqa: E402
                                           render_tag_in_scene)

from jax_departures import jax_detector_departures  # noqa: E402,F401
from torch_threads import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread",
                                     "jax_detector_departures")

CFG = dict(max_components=16, max_detections=4, ccl_iters=8)


def _scene(tag_id, cell_px, h=360, w=480, top=40, left=60, bg=235.0):
    img = np.full((h, w), bg, np.float32)
    if tag_id is not None:
        t = render_tag(tag_id, cell_px=cell_px)
        img[top:top + t.shape[0], left:left + t.shape[1]] = t
    return img


def _blank(seed=0, h=360, w=480):
    """Textured background with noise and no tag."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = 150 + 40 * np.sin(x / 23.0) * np.cos(y / 31.0)
    return np.clip(img + rng.normal(0, 6, (h, w)), 0, 255).astype(np.float32)


HARD_IDS = [5, 11, 23, 31, 42, 57]
# 24 px tags at an odd offset: decimation loses their decode while their
# quads survive, so stage B must recover them, in two waves of _ESC_K
B_IDS = [11, 23, 24, 25]
SCENES = {
    "easy_and_blank": [_scene(3, 12), _scene(17, 12, left=180), _blank()],
    "roi_escalation": [_scene(5, 6, top=200, left=300), _scene(9, 12)],
    "waves_6_of_8": [_scene(t, 6, top=40 + 20 * i, left=60 + 30 * i)
                     for i, t in enumerate(HARD_IDS)]
    + [_scene(3, 12), _scene(17, 12, left=180)],
    "stage_b_waves": [_scene(t, 3, top=201, left=301) for t in B_IDS]
    + [_scene(3, 12), _blank(1)],
}
EXPECTED = {
    "easy_and_blank": [3, 17, None],
    "roi_escalation": [5, 9],
    "waves_6_of_8": HARD_IDS + [3, 17],
    "stage_b_waves": B_IDS + [3, None],
}


def _assert_same(got: Detections, ref, corner_tol=0.05):
    ids, valid = got.ids.numpy(), got.valid.numpy()
    np.testing.assert_array_equal(ids, np.asarray(ref.ids))
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    if valid.any():
        assert np.abs(got.corners.numpy()
                      - np.asarray(ref.corners))[valid].max() <= corner_tol
        assert np.abs(got.centers.numpy()
                      - np.asarray(ref.centers))[valid].max() <= corner_tol


def test_stage_b_waves_scene_escalates():
    """The scene really takes stage B in waves: stage A leaves its four
    small tags and the blank frame unfound, stage B finds the tags."""
    frames = torch.from_numpy(np.stack(SCENES["stage_b_waves"]))
    cfg = DetectorConfig(**CFG)
    det, found, grays, rois, rscores = TR._stage_a(frames, cfg)
    assert found.tolist() == [False] * 4 + [True, False]
    _, found_b = TR._stage_b(grays, det, found, rois, rscores, cfg)
    assert found_b.tolist() == [True] * 5 + [False]


def test_robust_single_image_vs_reference():
    img = render_tag(12)
    ref = JR.detect_tags_robust(jnp.asarray(img))
    got = TR.detect_tags_robust(torch.from_numpy(img))
    assert got.ids.shape == (DetectorConfig().max_detections,)
    _assert_same(got, ref)
    assert 12 in got.ids[got.valid].tolist()


def _random_dets(seed, n, slots):
    """Detection sets with duplicated ids near each other, tied margins
    and invalid slots."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, (n, slots)).astype(np.int32)
    centers = rng.integers(0, 5, (n, slots, 2)).astype(np.float32) * 6.0
    corners = centers[:, :, None, :] + rng.normal(
        0, 3, (n, slots, 4, 2)).astype(np.float32)
    margin = rng.choice([12.0, 30.0, 55.5], (n, slots)).astype(np.float32)
    valid = rng.random((n, slots)) > 0.25
    return dict(ids=ids, corners=corners, centers=centers,
                decision_margin=margin,
                hamming=rng.integers(0, 3, (n, slots)).astype(np.int32),
                areas=rng.choice([16.0, 400.0, 900.0], (n, slots)).astype(
                    np.float32),
                valid=valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_by_margin_exact(seed):
    sets = [_random_dets(seed, 3, 8), _random_dets(seed + 10, 3, 8)]
    got = TR._merge_by_margin(
        [Detections(**{k: torch.from_numpy(v) for k, v in s.items()})
         for s in sets], 5)
    for f in range(3):
        ref = JR._merge_by_margin(
            [JDet(**{k: jnp.asarray(v[f]) for k, v in s.items()})
             for s in sets], 5)
        for name in Detections._fields:
            np.testing.assert_array_equal(getattr(got, name)[f].numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_top_rois_exact(seed):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 6, (2, 12, 2)).astype(np.float32) * 40.0
    bbox = np.concatenate([xy, xy + rng.choice([30.0, 60.0], (2, 12, 1))],
                          axis=-1).astype(np.float32)
    score = rng.choice([0.0, 300.0, 900.0, 1800.0], (2, 12)).astype(
        np.float32)                              # ties and dead slots
    boxes, scores = TR._top_rois(torch.from_numpy(bbox),
                                 torch.from_numpy(score), 4)
    for f in range(2):
        rb, rs = JR._top_rois(jnp.asarray(bbox[f]), jnp.asarray(score[f]), 4)
        np.testing.assert_array_equal(boxes[f].numpy(), np.asarray(rb))
        np.testing.assert_array_equal(scores[f].numpy(), np.asarray(rs))


def test_enhance_stack_variants():
    """The variant order the merge's tie-breaking depends on."""
    img = _blank(3, 64, 96)
    batch, gray, cl = TR._enhance_stack(torch.from_numpy(img), True, True,
                                        0.7)
    rb, rg, rc = JR._enhance_stack(jnp.asarray(img), True, True, 0.7)
    assert batch.shape == (4, 64, 96)
    np.testing.assert_array_equal(gray.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(rc))
    # blur within 1e-4 gray (conv summation order), gamma within one ulp
    np.testing.assert_allclose(batch[1].numpy(), np.asarray(rb[1]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_max_ulp(batch[3].numpy(), np.asarray(rb[3]), 1)


def test_staged_config_without_decimation_runs_stage_a_only():
    cfg = dataclasses.replace(DetectorConfig(**CFG), quad_decimate=1.0)
    frames = torch.from_numpy(np.stack(SCENES["roi_escalation"]))
    ref = JR.detect_tags_robust_staged(np.stack(SCENES["roi_escalation"]),
                                       JConfig(**{**CFG,
                                                  "quad_decimate": 1.0}))
    _assert_same(TR.detect_tags_robust_staged(frames, cfg), ref)


def _weak_frame(seed, px, tilt, h=360, w=640, n=12):
    """n tags of about `px` pixels tilted by about `tilt` degrees on a
    grey frame with noise: stage A finds their quads, most undecoded."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]],
                 np.float32)
    img = np.full((h, w), 180.0, np.float32)
    size = 0.05
    z = K[0, 0] * size / px
    for i in range(n):
        cx = 80 + (i % 4) * 160 + rng.uniform(-15, 15)
        cy = 60 + (i // 4) * 120 + rng.uniform(-15, 15)
        ax, az = np.radians(tilt + rng.uniform(-5, 5)), np.radians(
            rng.uniform(0, 90))
        R = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az),
                                                     0], [0, 0, 1]]) @ \
            np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                      [0, np.sin(ax), np.cos(ax)]])
        t = np.array([(cx - w / 2) * z / K[0, 0], (cy - h / 2) * z / K[1, 1],
                      z])
        g = render_tag_in_scene(int(rng.integers(0, 500)), R, t, K, size,
                                (h, w), background=180.0)
        img = np.where(np.abs(g - 180.0) > 1e-3, g, img)
    return np.clip(img + rng.normal(0, 2.0, img.shape), 0, 255).astype(
        np.float32)


def test_stage_a_roi_choice_with_many_weak_candidates():
    from repas_tpu.detect.detector import detect_tags as jdetect
    from repas_tpu.kernels.image import clahe as jclahe

    # (seed, px, tilt) of frames with 6 to 8 live candidates, most weak
    frames = np.stack([_weak_frame(*a) for a in [
        (0, 20, 0), (3, 20, 0), (4, 20, 0), (7, 20, 0), (7, 30, 45),
        (9, 30, 45), (0, 36, 55), (2, 36, 55)]])
    jcfg, cfg = JConfig(**CFG), DetectorConfig(**CFG)
    _, jfound, jgrays, jrois, jrs = JR._stage_a(jnp.asarray(frames), jcfg)
    _, jbox, jscore = jax.vmap(lambda g: jdetect(jclahe(g), jcfg,
                                                 with_candidates=True))(
        jgrays)
    _, found, _, rois, rs = TR._stage_a(torch.from_numpy(frames), cfg)
    jrois, jrs = np.asarray(jrois), np.asarray(jrs)
    jbox, jscore = np.asarray(jbox), np.asarray(jscore)
    rois, rs = rois.numpy(), rs.numpy()
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert ((jscore > 0).sum(axis=1) > TR._ROI_Q).all()
    strong = jrs >= 100.0
    np.testing.assert_array_equal(rs >= 100.0, strong)
    np.testing.assert_allclose(rs[strong], jrs[strong], rtol=1e-4)
    assert np.abs(rois - jrois)[strong].max(initial=0.0) <= 0.05
    # a weak ROI is one of the reference's candidate quads, though the
    # reference may rank it lower or score it 0
    for f in range(len(frames)):
        for box in rois[f][rs[f] > 0]:
            assert np.abs(jbox[f] - box).max(axis=-1).min() <= 1.0, (f, box)
