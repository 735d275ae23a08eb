"""The ten leaf ``jax.jit`` functions of the JAX package as the port's
compiled steps (``core.jit``): the canopy's ``canny_edges``,
``hough_horizontal_bar`` and ``refine_plant_mask``, the reports'
``point_to_mesh_distances`` and ``point_to_mesh_signed_distances``, the
renderer's ``render_pointcloud``, ``align_depth_to_color``,
``nv12_to_rgb``, ``yuyv_to_rgb`` and ``detector_pose``.

On the CPU a compiled step runs its function, so here:
  * each is a ``core.jit.Jitted`` whose parameters are the reference's,
    whose static arguments are the reference's (read as text with ast)
    plus the three recorded departures (``sigma``, ``max_angle_deg``,
    ``tag_size_m``: each keys a cache on the host), and whose scalar
    arguments are the reference's traced numeric defaults but those;
  * a scalar argument given as a 0-d float32 tensor, the form a graph
    runs it in, gives outputs bit-equal to the same value as a Python
    number;
  * the renderer and the alignment take a numpy camera through their
    public entry, with the outputs and the key of the tensors' call;
  * the canopy pieces, the report and the renderer with their scalars as
    tensors against the JAX functions on the scenes of
    ``tests/test_torch_canopy.py``, ``test_torch_eval.py`` and
    ``test_torch_render.py``, at those files' tolerances: edge maps,
    lines, masks and images equal, distances within 1e-6 relative plus
    1e-7 m.
The ``cuda``-marked cases (skipped without a card) capture and replay
each function on the card, bit-equal to its eager function, with no
synchronizing call inside a replay, and render two orbit views that
differ, each equal to its eager image. They need no JAX (the card's
machine has none; there the JAX cases skip).

Budget: under 15 s on one worker (JAX compiles the canopy pieces).
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.canopy import bar as TB, segment as TS  # noqa: E402
from repas_tpu_torch.core.jit import Jitted  # noqa: E402
from repas_tpu_torch.eval import reports as TR  # noqa: E402
from repas_tpu_torch.kernels import align as TA, color as TC  # noqa: E402
from repas_tpu_torch.kernels.image import rgb_to_gray  # noqa: E402
from repas_tpu_torch.pose import pnp as TP  # noqa: E402
from repas_tpu_torch.viz import render as TV  # noqa: E402
from test_torch_scenes import tilted_scene, uv_sphere  # noqa: E402

try:        # the reference and the scenes of its parity tests
    import jax.numpy as jnp

    from repas_tpu.canopy import bar as JB, segment as JS
    from repas_tpu.eval import reports as JR
    from repas_tpu.viz import render as JV
    from test_torch_canopy import SCENES, _gray, _line_equal
    from test_torch_eval import sphere_case  # noqa: F401
    from test_torch_render import K as RK, SHAPE, _cloud, _views
except (ImportError, pytest.skip.Exception):
    jnp = None
needs_jax = pytest.mark.skipif(jnp is None, reason="needs jax (the "
                               "reference) and its parity tests' scenes")

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (JAX file, function) -> the port's compiled step
LEAVES = {
    ("canopy/bar.py", "canny_edges"): TB.canny_edges,
    ("canopy/bar.py", "hough_horizontal_bar"): TB.hough_horizontal_bar,
    ("canopy/segment.py", "refine_plant_mask"): TS.refine_plant_mask,
    ("eval/reports.py", "point_to_mesh_distances"):
        TR.point_to_mesh_distances,
    ("eval/reports.py", "point_to_mesh_signed_distances"):
        TR.point_to_mesh_signed_distances,
    ("viz/render.py", "render_pointcloud"): TV.render_pointcloud,
    ("kernels/align.py", "align_depth_to_color"): TA.align_depth_to_color,
    ("kernels/color.py", "nv12_to_rgb"): TC.nv12_to_rgb,
    ("kernels/color.py", "yuyv_to_rgb"): TC.yuyv_to_rgb,
    ("pose/pnp.py", "detector_pose"): TP.detector_pose,
}
# arguments the reference traces that are static in the port: each keys
# a cache on the host (the blur's taps, the Hough angle tables, the tag's
# object points)
DEPARTURES = {"canny_edges": {"sigma"},
              "hough_horizontal_bar": {"max_angle_deg"},
              "detector_pose": {"tag_size_m"}}


def _reference(path, name):
    """(parameter names, static argnames, parameters with a numeric
    default) of the JAX function, read as text."""
    tree = ast.parse((ROOT / "repas_tpu" / path).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    static = set()
    for dec in fn.decorator_list:
        for kw in getattr(dec, "keywords", []):
            if kw.arg == "static_argnames":
                static |= set(ast.literal_eval(kw.value))
    args = fn.args.args
    numeric = {a.arg for a, d in zip(args[len(args) - len(fn.args.defaults):],
                                     fn.args.defaults)
               if isinstance(d, ast.Constant)
               and isinstance(d.value, (int, float))
               and not isinstance(d.value, bool)}
    return [a.arg for a in args], static, numeric


@pytest.mark.parametrize("leaf", sorted(LEAVES), ids=lambda x: x[1])
def test_compiled_with_the_reference_statics(leaf):
    step = LEAVES[leaf]
    params, static, numeric = _reference(*leaf)
    departed = DEPARTURES.get(leaf[1], set())
    assert isinstance(step, Jitted)
    assert list(step.signature.parameters) == params
    assert set(step.static_argnames) == static | departed
    assert set(step.scalar_argnames) == numeric - static - departed


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@needs_jax
@pytest.mark.parametrize("fn", ["canny_edges", "hough_horizontal_bar",
                                "render_pointcloud"])
def test_scalars_as_tensors_equal_python_numbers(fn):
    rgb = SCENES["tilt6"][0]
    gray = torch.from_numpy(_gray(rgb))
    if fn == "canny_edges":
        a = TB.canny_edges(gray, 40.0, 120.0)
        b = TB.canny_edges(gray, _f32(40.0), _f32(120.0))
    elif fn == "hough_horizontal_bar":
        edges = TB.canny_edges(gray)
        a = TB.hough_horizontal_bar(edges, threshold=40, min_line_frac=0.2)
        b = TB.hough_horizontal_bar(edges, threshold=_f32(40),
                                    min_line_frac=_f32(0.2))
        assert bool(a.found)
    else:
        x = torch.from_numpy(_cloud(3000))
        R, t = _views(_cloud(3000))[0]
        a = TV.render_pointcloud(x, RK, R, t, shape=SHAPE, background=0.25,
                                 z_near=0.45)
        b = TV.render_pointcloud(x, RK, R, t, shape=SHAPE,
                                 background=_f32(0.25), z_near=_f32(0.45))
        assert bool((a == 0.25).all(-1).any()) and bool((a != 0.25).any())
    assert _equal(tuple(a) if isinstance(a, tuple) else a,
                  tuple(b) if isinstance(b, tuple) else b)


def _align_case():
    y, x = np.mgrid[0:48, 0:64]
    depth = (0.8 + 0.002 * x + 0.001 * y).astype(np.float32)
    depth[::7, ::9] = 0.0
    Kd = np.array([[60.0, 0, 32.5], [0, 60.2, 24.1], [0, 0, 1]], np.float32)
    Kc = np.array([[75.0, 0, 40.0], [0, 75.0, 30.0], [0, 0, 1]], np.float32)
    a = np.radians(2.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    t = np.array([0.02, 0.001, -0.002], np.float32)
    return depth, (Kd, Kc, R, t)


@needs_jax
@pytest.mark.parametrize("fn", ["render_pointcloud", "align_depth_to_color"])
def test_numpy_camera_through_the_public_entry(fn):
    if fn == "render_pointcloud":
        x = torch.from_numpy(_cloud(3000))
        R, t = _views(_cloud(3000))[1]
        step, head, cam = TV.render_pointcloud, (x,), (RK, R, t)
        kw = {"shape": SHAPE}
    else:
        depth, cam = _align_case()
        step, head = TA.align_depth_to_color, (torch.from_numpy(depth),)
        kw = {"out_shape": (60, 80)}
    tensors = tuple(torch.from_numpy(c) for c in cam)
    assert torch.equal(step(*head, *cam, **kw), step(*head, *tensors, **kw))
    assert step.key(*head, *cam, **kw) == step.key(*head, *tensors, **kw)


@needs_jax
def test_canopy_pieces_with_tensor_scalars_match_reference():
    rgb = SCENES["tilt6"][0]
    g = _gray(rgb)
    je = np.asarray(JB.canny_edges(jnp.asarray(g), 50.0, 150.0))
    te = TB.canny_edges(torch.from_numpy(g), _f32(50.0), _f32(150.0))
    np.testing.assert_array_equal(te.numpy(), je)
    jl = JB.hough_horizontal_bar(jnp.asarray(je), threshold=40,
                                 min_line_frac=0.1)
    tl = TB.hough_horizontal_bar(te, threshold=_f32(40),
                                 min_line_frac=_f32(0.1))
    assert bool(jl.found)
    _line_equal(jl, tl)
    jseed = JS.green_seed_mask(jnp.asarray(rgb))
    jfg = JS.refine_plant_mask(jnp.asarray(rgb), jseed, iters=5)
    tfg = TS.refine_plant_mask(torch.from_numpy(rgb),
                               torch.from_numpy(np.array(jseed)), iters=5)
    np.testing.assert_array_equal(tfg.numpy(), np.asarray(jfg))


@needs_jax
def test_report_matches_reference(sphere_case):
    pts, verts, tris = sphere_case
    j = [np.asarray(f(jnp.asarray(pts), jnp.asarray(verts),
                      jnp.asarray(tris)))
         for f in (JR.point_to_mesh_distances,
                   JR.point_to_mesh_signed_distances)]
    t = [f(torch.from_numpy(pts), torch.from_numpy(verts),
           torch.from_numpy(tris)).numpy()
         for f in (TR.point_to_mesh_distances,
                   TR.point_to_mesh_signed_distances)]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.abs(t[1]), np.abs(j[1]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(np.sign(t[1])[np.abs(j[1]) > 5e-3],
                                  np.sign(j[1])[np.abs(j[1]) > 5e-3])


@needs_jax
def test_renderer_with_tensor_scalars_matches_reference():
    xyzrgb = _cloud()
    for R, t in _views(xyzrgb)[:2]:
        want = np.asarray(JV.render_pointcloud(
            jnp.asarray(xyzrgb), RK, R, t, shape=SHAPE, splat=2,
            background=0.5))
        got = TV.render_pointcloud(torch.from_numpy(xyzrgb), RK, R, t,
                                   shape=SHAPE, splat=2,
                                   background=_f32(0.5),
                                   z_near=_f32(1e-3))
        assert np.array_equal(got.numpy(), want)


# --- on the card -----------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


CARD_K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]], np.float32)
CARD_SHAPE = (120, 160)


def _card_cloud(n=20000, seed=0):
    """(N,6) xyzrgb: a flattened Gaussian blob at 0.6 m, uint8-range
    colours."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * [0.2, 0.15, 0.05] + [0, 0, 0.6]
    cols = rng.integers(0, 256, (n, 3))
    return np.concatenate([pts, cols], 1).astype(np.float32)


def _card_case(name, dev):
    """(step, args, kwargs) of one small call on the card, every tensor
    there (no host copy before the step)."""
    rgb = tilted_scene(6.0, 1)[0]
    gray = rgb_to_gray(torch.from_numpy(rgb)).to(dev)
    rng = np.random.default_rng(3)
    if name == "canny_edges":
        return TB.canny_edges, (gray, 50.0, 150.0), {}
    if name == "hough_horizontal_bar":
        return (TB.hough_horizontal_bar, (TB.canny_edges.fn(gray),),
                {"threshold": 40, "min_line_frac": 0.1})
    if name == "refine_plant_mask":
        r = torch.from_numpy(rgb).to(dev)
        return TS.refine_plant_mask, (r, TS.green_seed_mask(r)), {"iters": 5}
    if name.startswith("point_to_mesh"):
        verts, tris = uv_sphere(12, 18)
        d = rng.normal(size=(600, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts = (d * rng.uniform(0.06, 0.14, (600, 1))).astype(np.float32)
        return (getattr(TR, name), tuple(torch.from_numpy(v).to(dev)
                                         for v in (pts, verts, tris)),
                {"chunk": 64})
    if name == "render_pointcloud":
        x = _card_cloud()
        R, t = TV.orbit_views(x[:, :3].mean(0), 1.0, n=3)[1]
        return (TV.render_pointcloud, tuple(torch.from_numpy(v).to(dev)
                                            for v in (x, CARD_K, R, t)),
                {"shape": CARD_SHAPE})
    if name == "align_depth_to_color":
        depth, cam = _align_case()
        return (TA.align_depth_to_color,
                tuple(torch.from_numpy(v).to(dev) for v in (depth, *cam)),
                {"out_shape": (60, 80)})
    if name in ("nv12_to_rgb", "yuyv_to_rgb"):
        shape = (72, 64) if name == "nv12_to_rgb" else (48, 128)
        buf = rng.integers(0, 256, shape, dtype=np.uint8)
        return getattr(TC, name), (torch.from_numpy(buf).to(dev),), {}
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
    corners = np.array([[300.0, 220.0], [341.0, 222.0], [339.5, 263.0],
                        [298.5, 261.0]], np.float32)
    return (TP.detector_pose, (torch.from_numpy(corners).to(dev),
                               torch.from_numpy(K).to(dev)),
            {"tag_size_m": 0.05})


def _replay_strict(step, args, kwargs):
    """A call of the step with every synchronizing CUDA call raising."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", sorted(LEAVES), ids=lambda x: x[1])
def test_capture_replay_equals_eager_without_host_reads(dev, leaf):
    step, args, kwargs = _card_case(leaf[1], dev)
    step.clear()
    with torch.no_grad():
        first = step(*args, **kwargs)                # capture + replay
        again = _replay_strict(step, args, kwargs)   # replay alone
        want = step.fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert len(step.graphs) == 1
    for got in (first, again):
        assert _equal(tuple(got) if isinstance(got, tuple) else got,
                      tuple(want) if isinstance(want, tuple) else want)


@pytest.mark.cuda
def test_two_orbit_views_replay_with_their_own_camera(dev):
    x = _card_cloud()
    pts = torch.from_numpy(x).to(dev)
    TV.render_pointcloud.clear()
    imgs = []
    with torch.no_grad():
        for R, t in TV.orbit_views(x[:, :3].mean(0), 1.0, n=3)[:2]:
            got = TV.render_pointcloud(pts, CARD_K, R, t, shape=CARD_SHAPE)
            want = TV.render_pointcloud.fn(pts, CARD_K, R, t,
                                           shape=CARD_SHAPE)
            assert torch.equal(got, want)
            imgs.append(got)
    assert len(TV.render_pointcloud.graphs) == 1
    assert not torch.equal(imgs[0], imgs[1])

