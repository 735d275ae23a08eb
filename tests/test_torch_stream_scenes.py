"""Synthetic 240x320 RGB-D replay captures for the stream CLIs' tests
(``tests/test_torch_apps_*.py``): tags 9 and 16 on a plane at 0.45 m seen
by a camera that moves by a known rigid motion, written in the replay
layouts ``ReplayBackend`` reads (rgb_<ts>.png + depth_raw_<ts>.png); and
``run_both``, which runs a CLI as the JAX app and as the port's app.
Imports no jax at import time (numpy and the port's numpy renderer
only), so a card's test run could use the scenes too.
"""
import contextlib
import importlib
import json

import numpy as np
import torch

from repas_tpu_torch.detect.render import render_tag_in_scene
from repas_tpu_torch.io.image import write_depth_png, write_image

FX, CX, CY, H, W = 260.0, 160.0, 120.0, 240, 320
K = np.array([[FX, 0, CX], [0, FX, CY], [0, 0, 1.0]])
Z0, TAG = 0.45, 0.07
# tag centres on the plane z = Z0 of the world (the first camera's frame)
TAGS = {9: (-0.10, -0.04), 16: (0.09, -0.04)}
STEP = np.array([0.003, 0.002, 0.0])   # camera motion per stream frame (m)
# two Gaussian bumps toward the camera below tag 16 (centre x, y, sigma,
# height in m): relief that pins ICP in every direction
BUMPS = ((0.06, 0.07, 0.02, 0.03), (0.13, 0.10, 0.015, 0.02))


def surface_z(x, y):
    """World z of the scene's surface: the plane Z0 less the bumps."""
    return Z0 - sum(h * np.exp(-((x - bx) ** 2 + (y - by) ** 2)
                               / (2 * s * s)) for bx, by, s, h in BUMPS)


def rot_y(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])


# the first camera looks straight at the plane. Measured on 10 seeded
# frames of this scene (19 tags), JAX against the port: refined corners
# within 0.07 px, the median 0.0005 px; a camera tilted 8 degrees and
# turned 5 moved a corner by up to 0.23 px (a tied gradient plateau of
# the bf16 patches, which XLA's FMAs break by a search step; ROADMAP C)
R0 = np.eye(3)


def tag_in_camera(tid, R_wc=R0, c=np.zeros(3)):
    """Tag `tid`'s centre in the camera's frame (m)."""
    x, y = TAGS[tid]
    return R_wc.T @ (np.array([x, y, Z0]) - c)


def render_view(R_wc=R0, c=np.zeros(3), seed=0, depth_noise=0.0005,
                flipped=(9,)):
    """(rgb (H,W,3) u8, depth (H,W) f32 m) of the tag plane seen by a
    camera at world position c with camera-to-world rotation R_wc. The
    `flipped` tags are mounted upside down (tag 9, as the fusion's flip
    expects; none for a layout where every tag shares the plane's
    axes)."""
    img = np.full((H, W), 180.0, np.float32)
    R_cw = R_wc.T
    for tid, (x, y) in TAGS.items():
        R_tag = np.diag([-1.0, -1.0, 1.0]) if tid in flipped else np.eye(3)
        g = render_tag_in_scene(tid, R_cw @ R_tag,
                                R_cw @ (np.array([x, y, Z0]) - c), K, TAG,
                                (H, W), supersample=2)
        img = np.where(g != 180.0, g, img)
    rng = np.random.default_rng(seed)
    rgb = np.clip(np.repeat(img[..., None], 3, -1)
                  + rng.normal(0, 2, (H, W, 3)), 0, 255).astype(np.uint8)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(u - CX) / FX, (v - CY) / FX, np.ones_like(u)], -1) @ R_wc.T
    depth = (Z0 - c[2]) / d[..., 2]     # camera z along each pixel's ray
    for _ in range(20):                 # a fixed point onto the bumps
        depth = (surface_z(c[0] + depth * d[..., 0], c[1] + depth * d[..., 1])
                 - c[2]) / d[..., 2]
    depth = depth + rng.normal(0, depth_noise, (H, W))
    return rgb, depth.astype(np.float32)


def write_frame(d, stamp, rgb, depth, color="rgb", depth_name="depth_raw"):
    """One replay frame: <color>_<stamp>.png + <depth_name>_<stamp>.png
    (u16 mm)."""
    d.mkdir(parents=True, exist_ok=True)
    write_image(d / f"{color}_{stamp}.png", rgb)
    write_depth_png(d / f"{depth_name}_{stamp}.png", depth)


def write_intrinsics(path):
    path.write_text(json.dumps({"fx": FX, "fy": FX, "cx": CX, "cy": CY,
                                "width": W, "height": H}))
    return path


def write_stream(d, n, seed=0):
    """n frames of the camera moving by STEP per frame."""
    for k in range(n):
        rgb, depth = render_view(c=k * STEP, seed=seed + k)
        write_frame(d, f"20250101_0000{k:02d}", rgb, depth)
    return d


@contextlib.contextmanager
def one_torch_thread():
    """torch's CPU ops on one thread for the block: the suite runs one
    worker process per core, and a torch thread pool per worker spins
    against the others (a 2 s detector call took 75 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_both(name, args, tmp_path, outs=()):
    """Run the JAX app and the port app (--device cpu, one torch thread)
    with `args`, where each "{out}" becomes <tmp>/ref or <tmp>/port.
    Returns (ref dir, port dir, ref return value, port return value)."""
    dirs, rets = [], []
    for pkg, extra in (("repas_tpu", []),
                       ("repas_tpu_torch", ["--device", "cpu"])):
        d = tmp_path / ("ref" if pkg == "repas_tpu" else "port")
        d.mkdir(parents=True, exist_ok=True)
        mod = importlib.import_module(f"{pkg}.apps.{name}")
        with one_torch_thread():
            rets.append(mod.main([a.replace("{out}", str(d)) for a in args]
                                 + extra))
        for o in outs:
            assert (d / o).exists(), (pkg, o)
        dirs.append(d)
    return (*dirs, *rets)


def angle_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees, atan2(|sin|, cos) in float64."""
    Rr = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    return float(np.degrees(np.arctan2(np.linalg.norm(w),
                                       (np.trace(Rr) - 1) / 2)))


def jsonl(path):
    return [json.loads(line) for line in open(path)]


def stream_args(d, n=3):
    """A stream of n frames under d and track_stream's arguments for it."""
    write_stream(d / "frames", n)
    return ["--source", str(d / "frames"), "--intrinsics",
            str(write_intrinsics(d / "K.json")), "--tag-size", str(TAG)]


def track_both(args, tmp_path, extra):
    """track_stream as the JAX app and as the port's app: both JSONLs."""
    ref, port, _, _ = run_both(
        "track_stream", args + ["--out", "{out}/poses.jsonl", *extra],
        tmp_path, ["poses.jsonl"])
    return jsonl(ref / "poses.jsonl"), jsonl(port / "poses.jsonl")


def check_pipeline_records(ref, port):
    """track_stream's frame-pipeline records (the JAX app's, the port's)
    at the tolerances of tests/test_torch_apps_stream.py."""
    assert len(ref) == len(port) >= 1
    for a, b in zip(ref, port):
        assert (a["frame"], a["timestamp"]) == (b["frame"], b["timestamp"])
        assert a["ids"] == b["ids"] and sorted(a["ids"]) == [9, 16]
        assert angle_deg(a["R_avg"], b["R_avg"]) <= 0.25
        np.testing.assert_allclose(b["anchor_P_depth"], a["anchor_P_depth"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(b["margins"], a["margins"], rtol=0,
                                   atol=0.25)
        # tag 16 (the anchor) sits on the plane at Z0
        assert abs(b["anchor_P_depth"][2] - Z0) < 0.005


def test_stream_scene_layout(tmp_path):
    rgb, depth = render_view()
    assert rgb.shape == (H, W, 3) and depth.shape == (H, W)
    # both tags drawn: dark cells inside each tag's projected square, the
    # depth there the plane's
    for tid in TAGS:
        p = tag_in_camera(tid)
        u, v = int(FX * p[0] / p[2] + CX), int(FX * p[1] / p[2] + CY)
        assert rgb[v - 15:v + 15, u - 15:u + 15].min() < 60
        assert abs(float(depth[v, u]) - p[2]) < 0.003
    # a turned camera sees the plane farther off-axis on one side
    _, d2 = render_view(rot_y(8.0), np.array([0.05, 0.0, 0.0]))
    assert d2[:, 0].mean() != d2[:, -1].mean()
    write_stream(tmp_path, 2)
    assert len(list(tmp_path.glob("rgb_*.png"))) == 2
