"""The canopy-height, calibration and surface-error paths on the card
against the port on the CPU, at test size (``chip_smoke.py``'s
canopy_calib_eval checks).

Marked ``cuda``: they skip where torch sees no CUDA device. On a machine
with a card: ``python -m pytest -m cuda tests/test_torch_canopy_cuda.py``.
Tolerances: ``measure_plant_height``'s found, bar_px and canopy_px equal
and the height within 1e-5 m (the card's atan2 and log may round an ulp
otherwise, which could move an edge pixel or a near-tied bin); board
corners snapped equal and refined within 1e-3 px (the card sums the
window in another order); ``calibrate_camera`` on 3 views: noise-free,
f and c within 0.01 px, k1 and k2 within 1e-3, RMS within 1e-4 px; with
0.1 px of noise (K about 10 px from the truth, a flat valley) f and c
within 0.5 px (measured 0.23 px on an H100) and RMS within 1e-4 px
(cuBLAS sums the normal equations in another order, and the f32 LM
stops elsewhere in the valley);
signed point-to-mesh distances within 1e-6 relative plus 1e-7 m, and the
sign equal away from the surface.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.calib import checkerboard as PC  # noqa: E402
from repas_tpu_torch.canopy import measure_plant_height  # noqa: E402
from repas_tpu_torch.core.config import CanopyConfig  # noqa: E402
from repas_tpu_torch.eval.reports import (  # noqa: E402
    point_to_mesh_signed_distances)
from test_torch_scenes import (K_CAL, board_pose, render_view,  # noqa: E402
                               synth_views, tilted_scene, uv_sphere)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("angle,seed", [(6.0, 1), (-9.0, 2)])
def test_measure_plant_height_card_vs_cpu(dev, angle, seed):
    rgb, depth = tilted_scene(angle, seed)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1.0]])
    cfg = CanopyConfig(hough_threshold=40)
    cpu = measure_plant_height(torch.from_numpy(rgb),
                               torch.from_numpy(depth), K, cfg)
    gpu = measure_plant_height(torch.from_numpy(rgb).to(dev),
                               torch.from_numpy(depth).to(dev), K, cfg)
    assert gpu.found.device.type == "cuda"
    assert bool(gpu.found) == bool(cpu.found)
    for k in ("bar_px", "canopy_px"):
        np.testing.assert_array_equal(getattr(gpu, k).cpu().numpy(),
                                      getattr(cpu, k).numpy(), err_msg=k)
    assert abs(float(gpu.plant_height_m) - float(cpu.plant_height_m)) < 1e-5


def _board(seed):
    """A 640x480 board image with 9x7 inner corners, oblique, blurred."""
    R, t = board_pose(30, 12, 5, 0.55)
    return render_view(K_CAL, np.array([-0.2, 0.07, 0, 0, 0.0]), R, t,
                       blur=0.8, seed=seed)


def test_checkerboard_corners_card_vs_cpu(dev):
    img = _board(0)
    c_cpu, ok_cpu = PC.detect_checkerboard_corners(torch.from_numpy(img), 9, 7)
    c_gpu, ok_gpu = PC.detect_checkerboard_corners(
        torch.from_numpy(img).to(dev), 9, 7)
    assert bool(ok_cpu) and bool(ok_gpu)
    np.testing.assert_array_equal(c_gpu.cpu().numpy(), c_cpu.numpy())
    r_cpu = PC.refine_corners_subpix(torch.from_numpy(img), c_cpu)
    r_gpu = PC.refine_corners_subpix(torch.from_numpy(img).to(dev), c_gpu)
    np.testing.assert_allclose(r_gpu.cpu().numpy(), r_cpu.numpy(), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("noise,k_tol,dist_tol", [(0.0, 0.01, 1e-3),
                                                   (0.1, 0.5, None)])
def test_calibrate_camera_3_views_card_vs_cpu(dev, noise, k_tol, dist_tol):
    objs, imgs = synth_views(3, noise=noise, seed=2)
    cpu = PC.calibrate_camera(objs, imgs, (1280, 720), device="cpu")
    gpu = PC.calibrate_camera(objs, imgs, (1280, 720), device=dev)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=0, atol=k_tol)
    if dist_tol is not None:
        np.testing.assert_allclose(gpu[1][:2], cpu[1][:2], rtol=0,
                                   atol=dist_tol)
    assert abs(gpu[2] - cpu[2]) < 1e-4


def test_point_to_mesh_signed_card_vs_cpu(dev):
    verts, tris = uv_sphere(24, 36)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(5000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * rng.uniform(0.09, 0.11, (5000, 1))).astype(np.float32)
    args = [torch.from_numpy(a) for a in (pts, verts, tris)]
    cpu = point_to_mesh_signed_distances(*args).numpy()
    gpu = point_to_mesh_signed_distances(*[a.to(dev) for a in args]
                                         ).cpu().numpy()
    np.testing.assert_allclose(np.abs(gpu), np.abs(cpu), rtol=1e-6,
                               atol=1e-7)
    away = np.abs(cpu) > 1e-5
    np.testing.assert_array_equal(np.sign(gpu)[away], np.sign(cpu)[away])
