"""The calibrated-camera path of the port against the JAX package: the
Brown-Conrady model, deprojection, the distorting renderer, and
process_frame with distortion coefficients on test_distortion.py's scene.

Tolerances (stated per quantity):
  * distort_normalized: exact (the same f32 operations in the same order;
    measured 0);
  * undistort_points: 2.5e-7 in normalized coords, 2e-4 px: XLA contracts
    the polynomial's multiply-adds into FMAs, eager torch does not, and
    the 10 fixed-point steps carry the ulps (measured 1.2e-7, 8.9e-5 px);
  * deproject_pixels, depth_image_to_points, project_points,
    reprojection_error: 1e-6 relative;
  * z_scale_correction: 1e-6 relative; the renderer: exact (host numpy);
  * process_frame with dist: ROADMAP C's gates (ids and valid exact,
    corners <= 0.05 px, margins <= 0.25 gray, R <= 0.25 deg, t <= 0.1 mm,
    err <= 2e-3 px; measured 0.0017 px, 0.0066 gray, 0.012 deg, 0.0024 mm,
    2e-4 px), and the golden's own truth gates.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.core.config import PipelineConfig as RefConfig  # noqa: E402
from repas_tpu.core.config import PnPConfig as RefPnP  # noqa: E402
from repas_tpu.detect import render as JR  # noqa: E402
from repas_tpu.kernels import pointcloud as JPc  # noqa: E402
from repas_tpu.kernels import project as JPr  # noqa: E402
from repas_tpu.pipeline import process_frame as ref_frame  # noqa: E402
from repas_tpu.pose import depth_correct as JD  # noqa: E402
from repas_tpu_torch.core.config import from_reference  # noqa: E402
from repas_tpu_torch.core.transforms import rodrigues  # noqa: E402
from repas_tpu_torch.detect import render as TR  # noqa: E402
from repas_tpu_torch.kernels import pointcloud as TPc  # noqa: E402
from repas_tpu_torch.kernels import project as TPr  # noqa: E402
from repas_tpu_torch.pipeline import process_frame  # noqa: E402
from repas_tpu_torch.pose import depth_correct as TD  # noqa: E402

K = np.array([[748.9, 0, 639.87], [0, 748.35, 361.95], [0, 0, 1.0]],
             np.float32)
DIST5 = np.array([-0.24, 0.095, 0.0012, -0.0008, 0.018], np.float32)
DIST8 = np.array([0.092, -0.115, 0.0014, 0.002, 0.046, 0.01, -0.02, 0.005],
                 np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= rtol * np.maximum(np.abs(ref), 1.0))


@pytest.mark.parametrize("dist", [DIST5, DIST8], ids=["k5", "k8"])
def test_distort_and_undistort_vs_reference(dist):
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.9, 0.9, (400, 2)).astype(np.float32)
    ref = np.asarray(JPr.distort_normalized(jnp.asarray(xy),
                                            jnp.asarray(dist)))
    got = TPr.distort_normalized(_t(xy), _t(dist)).numpy()
    np.testing.assert_array_equal(got, ref)

    uv = rng.uniform([0, 0], [1280, 720], (400, 2)).astype(np.float32)
    ref = np.asarray(jax.jit(JPr.undistort_points)(
        jnp.asarray(uv), jnp.asarray(K), jnp.asarray(dist)))
    got = TPr.undistort_points(_t(uv), _t(K), _t(dist)).numpy()
    assert np.abs(got - ref).max() <= 2.5e-7
    assert np.abs(got - ref).max() * K[0, 0] <= 2e-4


@pytest.mark.parametrize("dist", [None, DIST5], ids=["none", "k5"])
def test_deproject_and_project_vs_reference(dist):
    rng = np.random.default_rng(1)
    uv = rng.uniform([0, 0], [1280, 720], (300, 2)).astype(np.float32)
    z = rng.uniform(0.3, 2.0, 300).astype(np.float32)
    jd = None if dist is None else jnp.asarray(dist)
    td = None if dist is None else _t(dist)
    ref = np.asarray(jax.jit(JPr.deproject_pixels)(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(K), jd))
    got = TPr.deproject_pixels(_t(uv), _t(z), _t(K), td).numpy()
    _close(got, ref, 1e-6)

    obj = rng.uniform(-0.1, 0.1, (12, 3)).astype(np.float32)
    rvec = np.array([0.3, -0.2, 0.15], np.float32)
    tvec = np.array([0.05, -0.02, 0.6], np.float32)
    ref = np.asarray(JPr.project_points(jnp.asarray(obj), jnp.asarray(rvec),
                                        jnp.asarray(tvec), K, jd))
    got = TPr.project_points(_t(obj), _t(rvec), _t(tvec), _t(K), td).numpy()
    _close(got, ref, 1e-6)
    noisy = ref + rng.normal(0, 0.5, ref.shape).astype(np.float32)
    e_ref = float(JPr.reprojection_error(jnp.asarray(obj), jnp.asarray(noisy),
                                         jnp.asarray(rvec), jnp.asarray(tvec),
                                         K, jd))
    e_got = float(TPr.reprojection_error(_t(obj), _t(noisy), _t(rvec),
                                         _t(tvec), _t(K), td))
    assert abs(e_got - e_ref) <= 1e-6 * e_ref


def test_depth_image_to_points_and_z_scale_vs_reference():
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.0, 3.0, (2, 24, 40)).astype(np.float32)
    Kd = np.array([[50.0, 0, 19.5], [0, 52.0, 12.0], [0, 0, 1]], np.float32)
    ref = np.asarray(jax.vmap(lambda d: JPc.depth_image_to_points(
        d, jnp.asarray(Kd)))(jnp.asarray(depth)))
    _close(TPc.depth_image_to_points(_t(depth), _t(Kd)).numpy(), ref, 1e-6)

    t = np.array([[0.1, -0.05, 0.5], [0.0, 0.0, 1e-12], [0.2, 0.1, -0.7]],
                 np.float32)
    z = np.array([0.55, 0.3, 0.9], np.float32)
    got_t, got_s = TD.z_scale_correction(_t(t), _t(z))
    for i in range(3):
        ref_t, ref_s = JD.z_scale_correction(jnp.asarray(t[i]), z[i])
        _close(got_t[i].numpy(), ref_t, 1e-6)
        _close(got_s[i].numpy(), ref_s, 1e-6)


def test_distorting_renderer_equals_reference():
    R = rodrigues(_t(np.array([0.25, -0.2, 0.1], np.float32))).numpy()
    t = np.array([0.01, -0.01, 0.3], np.float32)
    args = (5, R, t, K, 0.05, (90, 120))
    for dist in (None, DIST5, DIST8):
        np.testing.assert_array_equal(
            TR.render_tag_in_scene(*args, supersample=3, dist=dist),
            JR.render_tag_in_scene(*args, supersample=3, dist=dist))
    x, y = np.meshgrid(np.linspace(-0.8, 0.8, 9), np.linspace(-0.5, 0.5, 7))
    for got, ref in zip(TR._undistort_normalized_np(x, y, DIST8),
                        JR._undistort_normalized_np(x, y, DIST8)):
        np.testing.assert_array_equal(got, ref)


# test_distortion.py's scene: tag 5 of 0.0909 m at t=(0.08,0.05,0.55),
# rvec (0.25,-0.2,0.1), f=740 at 1280x720, checkerboard-size coefficients
H, W = 720, 1280
F = 740.0
K_D = np.array([[F, 0, 640], [0, F, 360], [0, 0, 1.0]], np.float32)
DIST = np.array([-0.24, 0.095, 0.0012, -0.0008, 0.018], np.float32)
TAG = 0.0303 * 3
TAG_ID = 5


def distorted_scene():
    """(R, t, rgb (720,1280,3) uint8, depth u16): the golden's scene,
    rendered (supersample 3) only in the window that holds the tag and
    its margin, through the intrinsics shifted to that window, and pasted
    into the 180-gray background; the full render takes half a minute."""
    R = rodrigues(_t(np.array([0.25, -0.2, 0.1], np.float32))).numpy()
    t = np.array([0.08, 0.05, 0.55], np.float32)
    top, left, hh, ww = 300, 600, 330, 330
    Kw = K_D.copy()
    Kw[0, 2] -= left
    Kw[1, 2] -= top
    gray = np.full((H, W), 180.0, np.float32)
    gray[top:top + hh, left:left + ww] = TR.render_tag_in_scene(
        TAG_ID, R, t, Kw, TAG, (hh, ww), supersample=3, dist=DIST)
    assert (gray[[top, top + hh - 1]] == 180.0).all()
    assert (gray[:, [left, left + ww - 1]] == 180.0).all()
    rgb = np.repeat(gray[..., None], 3, -1).astype(np.uint8)
    depth = np.full((H, W), int(t[2] * 1000), np.uint16)
    return R, t, rgb, depth


def _angle_deg(Ra, Rb):
    Rr = np.swapaxes(Ra, -1, -2).astype(np.float64) @ Rb.astype(np.float64)
    c = np.clip((np.trace(Rr, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


def test_process_frame_with_dist_vs_reference():
    R, t, rgb, depth = distorted_scene()
    cfg = RefConfig(pnp=RefPnP(tag_size_m=TAG))
    tcfg = from_reference(dataclasses.asdict(cfg))
    ref = ref_frame(jnp.asarray(rgb), jnp.asarray(depth), K_D, cfg, True,
                    jnp.asarray(DIST))
    got = process_frame(_t(rgb), _t(depth), K_D, tcfg, dist=DIST)
    rd, gd = ref.detections, got.detections
    np.testing.assert_array_equal(gd.ids.numpy(), np.asarray(rd.ids))
    v = np.asarray(rd.valid)
    np.testing.assert_array_equal(gd.valid.numpy(), v)
    assert np.abs(gd.corners.numpy() - np.asarray(rd.corners))[v].max() \
        <= 0.05
    assert np.abs(gd.decision_margin.numpy()
                  - np.asarray(rd.decision_margin))[v].max() <= 0.25
    i = int(np.argmax(np.asarray(rd.ids) == TAG_ID))
    assert int(rd.ids[i]) == TAG_ID
    assert _angle_deg(np.asarray(ref.pose.R)[i], got.pose.R[i].numpy()) \
        <= 0.25
    assert np.abs(got.pose.t[i].numpy() - np.asarray(ref.pose.t)[i]).max() \
        <= 1e-4
    assert abs(float(got.pose.err_px[i]) - float(ref.pose.err_px[i])) <= 2e-3
    assert tuple(got.pointcloud.shape) == (6, H * W)

    # the golden's truth gates: with the coefficients under 1 mm and 0.3
    # degrees; without them visibly off (the proof that dist flows)
    terr = np.linalg.norm(got.pose.t[i].numpy() - t) * 1000
    assert terr < 1.0 and _angle_deg(R, got.pose.R[i].numpy()) < 0.3
    bare = process_frame(_t(rgb), _t(depth), K_D, tcfg,
                         with_pointcloud=False)
    j = int(np.argmax(bare.detections.ids.numpy() == TAG_ID))
    assert np.linalg.norm(bare.pose.t[j].numpy() - t) * 1000 > 3.0
    assert _angle_deg(R, bare.pose.R[j].numpy()) > 0.8
    assert tuple(bare.pointcloud.shape) == (6, 0)


def test_pipeline_dist_padding_and_none_path():
    """dist pads to 8 and truncates past 8; a zero vector gives the
    undistorted result to LM rounding; None leaves the cloud as before."""
    from repas_tpu_torch.detect.render import example_frame

    rgb, depth, Kb = example_frame(180, 320)
    rgbs, depths = _t(rgb[None]), _t(depth[None])
    base = process_frame(rgbs[0], depths[0], Kb)
    five = process_frame(rgbs[0], depths[0], Kb, dist=DIST5)
    padded = process_frame(rgbs[0], depths[0], Kb,
                           dist=np.concatenate([DIST5, np.zeros(5,
                                                                np.float32)]))
    torch.testing.assert_close(padded.pose.t, five.pose.t, rtol=0, atol=0)
    zero = process_frame(rgbs[0], depths[0], Kb, dist=np.zeros(8))
    assert torch.equal(zero.detections.ids, base.detections.ids)
    v = base.detections.valid
    assert (zero.pose.t - base.pose.t)[v].abs().max() <= 1e-6
    assert torch.equal(zero.pointcloud, base.pointcloud)
