"""Checkerboard calibration (``repas_tpu_torch.calib``) against the JAX
package on the CPU: boards rendered by tests/test_torch_scenes.py's numpy
renderer (Brown-Conrady lens, supersampling, blur, noise; no cv2) from a
numpy seed, 640x480 with 9x7 inner corners, and
``tests/test_calibration.py``'s synthetic views.

Tolerances, with what was measured (jax 0.9.0, torch 2.13 CPU):
- ``_saddle_response``: within 1e-5 of max |response| (measured 2.6e-6:
  XLA sums the 11-tap blur in an order the port does not reproduce);
- ``_nms_topk`` on one response: uv and scores exact, ties ranked by
  index as ``lax.top_k``; a plateau of tied maxima keeps its first pixel
  (the reference keeps all of them, ROADMAP C);
- ``detect_checkerboard_corners``: ok and the snapped corners equal on
  the rendered views; on a pixel-aligned, noise-free board (exact
  two-pixel plateaus) within 1 px (another pixel of the plateau);
  ``refine_corners_subpix`` within 2e-4 px (measured 1.5e-4);
- ``_homography_dlt`` and ``_zhang_init``: exact (the same numpy code);
- ``calibrate_camera`` (f32 LM, stops in a flat valley): on 8 noise-free
  views f, c within 0.01 px (measured 0.003), k1, k2 within 1e-3, RMS
  within 1e-5 px; on 12 views with 0.2 px noise, where k3 is not
  determined (both land near k3 ~ 100), RMS within 1e-4 px (measured
  7e-6, the port's lower), f and c within 0.5 % (measured 2.4 px).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.calib import checkerboard as JC  # noqa: E402
from repas_tpu.core import config as JCFG  # noqa: E402
from repas_tpu_torch.calib import checkerboard as PC  # noqa: E402
from repas_tpu_torch.core import config as TCFG  # noqa: E402
from test_torch_scenes import (COLS, K_CAL, ROWS, board_pose,  # noqa: E402
                               render_view, synth_views)

VIEWS = {
    "oblique": (board_pose(50, 18, 4, 0.55), np.zeros(5), 0.6),
    "blurred": (board_pose(25, 10, 4, 0.55), np.zeros(5), 1.8),
    "distorted": (board_pose(35, 8, 4, 0.55),
                  np.array([-0.28, 0.09, 0.001, -0.001, 0.0]), 0.6),
    "rolled": (board_pose(20, -25, 30, 0.6, 0.05, -0.03),
               np.array([-0.2, 0.07, 0.0, 0.0, 0.0]), 1.0),
}


@pytest.fixture(scope="module")
def views():
    out = {}
    for s, (name, ((R, t), dist, blur)) in enumerate(VIEWS.items()):
        img = render_view(K_CAL, dist, R, t, blur=blur, seed=s)
        jc, jok = JC.detect_checkerboard_corners(jnp.asarray(img), COLS, ROWS)
        jr = JC.refine_corners_subpix(jnp.asarray(img), jc)
        out[name] = (img, np.asarray(jc), bool(jok), np.asarray(jr))
    return out


def test_calibration_config_equals_reference():
    assert (dataclasses.asdict(TCFG.CalibrationConfig())
            == dataclasses.asdict(JCFG.CalibrationConfig()))


def test_saddle_response_close(views):
    img = views["oblique"][0]
    j = np.asarray(JC._saddle_response(jnp.asarray(img)))
    t = PC._saddle_response(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


def test_nms_topk_ties_by_index():
    rng = np.random.default_rng(3)
    resp = np.round(rng.random((60, 80)) * 8).astype(np.float32)  # ties
    resp[rng.random(resp.shape) < 0.5] = 0.0
    ju, js = JC._nms_topk(jnp.asarray(resp), 400)
    tu, ts = PC._nms_topk(torch.from_numpy(resp), 400)
    # a plateau of tied maxima: the reference keeps every pixel of it, the
    # port the first in raster order; otherwise the same peaks in the same
    # (score, index) order
    jpk = [tuple(p) for p in np.asarray(ju)[np.asarray(js) > 0]]
    tpk = [tuple(p) for p in tu.numpy()[ts.numpy() > 0]]
    assert len(tpk) < len(jpk)
    assert [p for p in jpk if p in set(tpk)] == tpk
    plateau = np.zeros((30, 30), np.float32)
    plateau[10, 10:12] = 5.0
    plateau[20, 20] = 4.0
    tu, ts = PC._nms_topk(torch.from_numpy(plateau), 3)
    assert tu.numpy().tolist()[:2] == [[10.0, 10.0], [20.0, 20.0]]


def test_nms_topk_exact_without_plateaus():
    rng = np.random.default_rng(4)
    resp = rng.random((90, 120)).astype(np.float32)
    ju, js = JC._nms_topk(jnp.asarray(resp), 60)
    tu, ts = PC._nms_topk(torch.from_numpy(resp), 60)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("name", list(VIEWS))
def test_detect_and_refine(views, name):
    img, jc, jok, jr = views[name]
    tc, tok = PC.detect_checkerboard_corners(torch.from_numpy(img), COLS,
                                             ROWS)
    assert jok and bool(tok)
    np.testing.assert_array_equal(tc.numpy(), jc)
    tr = PC.refine_corners_subpix(torch.from_numpy(img), tc)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=2e-4)


def test_pixel_aligned_board_plateaus():
    """tests/test_calibration.py's render_board: every corner sits between
    pixels, so the response has exact two-pixel plateaus."""
    cols, rows, cell, margin = 7, 5, 24, 40
    h, w = rows * cell + 2 * margin + cell, cols * cell + 2 * margin + cell
    img = np.full((h, w), 200.0, np.float32)
    for i in range(rows + 1):
        for j in range(cols + 1):
            if (i + j) % 2 == 0:
                img[margin + i * cell:margin + (i + 1) * cell,
                    margin + j * cell:margin + (j + 1) * cell] = 40.0
    truth = np.array([[margin + j * cell - 0.5, margin + i * cell - 0.5]
                      for i in range(1, rows + 1)
                      for j in range(1, cols + 1)], np.float32)
    jc, jok = JC.detect_checkerboard_corners(jnp.asarray(img), cols, rows)
    tc, tok = PC.detect_checkerboard_corners(torch.from_numpy(img), cols,
                                             rows)
    assert bool(jok) and bool(tok)
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1.0
    jr = np.asarray(JC.refine_corners_subpix(jnp.asarray(img), jc))
    tr = PC.refine_corners_subpix(torch.from_numpy(img), tc).numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    assert np.abs(tr - truth).max() < 0.35


def test_median_even_count():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(PC._median(x)) == float(jnp.median(jnp.asarray(x.numpy())))
    assert float(PC._median(x)) == 2.5


def test_zhang_init_exact():
    objs, imgs = synth_views(4, seed=5)
    Hj = [JC._homography_dlt(o[:, :2], i) for o, i in zip(objs, imgs)]
    Ht = [PC._homography_dlt(o[:, :2], i) for o, i in zip(objs, imgs)]
    for a, b in zip(Hj, Ht):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PC._zhang_init(Ht), JC._zhang_init(Hj))


@pytest.mark.parametrize("n_views,noise,seed,f_tol,k_tol,rms_tol", [
    (8, 0.0, 0, 0.01, 1e-3, 1e-5),
    (12, 0.2, 1, 0.005 * 760, None, 1e-4),
])
def test_calibrate_camera(n_views, noise, seed, f_tol, k_tol, rms_tol):
    objs, imgs = synth_views(n_views, noise=noise, seed=seed)
    jK, jd, jrms, _, _ = JC.calibrate_camera(objs, imgs, (1280, 720),
                                             iters=60)
    tK, td, trms, trv, ttv = PC.calibrate_camera(objs, imgs, (1280, 720),
                                                 iters=60, device="cpu")
    assert trv.shape == (n_views, 3) and ttv.shape == (n_views, 3)
    np.testing.assert_allclose(tK, jK, rtol=0, atol=f_tol)
    if k_tol is not None:
        np.testing.assert_allclose(td[:2], jd[:2], rtol=0, atol=k_tol)
    assert abs(trms - jrms) < rms_tol
    assert td.shape == (8,) and not td[5:].any()
