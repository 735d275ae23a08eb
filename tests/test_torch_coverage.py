"""Completeness of the port: every module of the JAX package and every
tool of tools/ has its counterpart file in repas_tpu_torch/, the entry
points of __graft_entry__.py are exported by repas_tpu_torch.graft_entry,
every function of bench.py but the state file's has its namesake in
repas_tpu_torch.bench,
every name a JAX subpackage exports is exported by the port's
subpackage, no module of the port imports jax or the JAX package, and every CLI of the port defaults to
--device cuda and raises without a card.

The JAX sources are read as text (ast), so this file imports no jax.
"""
import ast
import importlib
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "repas_tpu", ROOT / "repas_tpu_torch"
# JAX modules whose port lives under another name: the Pallas CCL kernels
# are the CUDA band kernel's wrapper (B1) and the tiled CCL's (B4)
RENAMED = {"kernels/ccl_pallas.py": ("kernels/ccl_cuda.py",
                                     "kernels/ccl_tiled.py")}


def _modules(pkg):
    return sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py"))


def _all_names(init: pathlib.Path):
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


@pytest.mark.parametrize("rel", _modules(JAX_PKG))
def test_every_jax_module_has_a_port(rel):
    for r in RENAMED.get(rel, (rel,)):
        assert (PORT_PKG / r).is_file(), f"repas_tpu/{rel} -> missing {r}"


@pytest.mark.parametrize("init", sorted(
    str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("__init__.py")
    if _all_names(p) is not None))
def test_every_exported_name_is_exported_by_the_port(init):
    names = _all_names(JAX_PKG / init)
    mod = ".".join(("repas_tpu_torch", *pathlib.Path(init).parent.parts))
    port = importlib.import_module(mod)
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{mod} lacks {missing}"
    assert set(names) <= set(port.__all__)


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "tools").glob("*.py")))
def test_every_jax_tool_has_a_port(name):
    assert (PORT_PKG / "tools" / name).is_file(), f"tools/{name}"


def test_graft_entry_has_a_port():
    mod = importlib.import_module("repas_tpu_torch.graft_entry")
    assert {"entry", "dryrun_multichip"} <= set(mod.__all__)
    assert callable(mod.entry) and callable(mod.dryrun_multichip)


# functions of bench.py the port leaves out: the state file (the port
# reads and writes none), its wall-clock helper (a closure in main) and
# the real-capture loader (the captures are not in the repository)
BENCH_NOT_PORTED = {"_load_state", "_save_state", "_remaining",
                    "_real_capture_batch"}


def test_bench_has_a_port():
    tree = ast.parse((ROOT / "bench.py").read_text())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    mod = importlib.import_module("repas_tpu_torch.bench")
    assert BENCH_NOT_PORTED <= names
    missing = [n for n in sorted(names - BENCH_NOT_PORTED)
               if not callable(getattr(mod, n, None))]
    assert not missing, f"repas_tpu_torch/bench.py lacks {missing}"


def test_no_port_module_imports_jax():
    bad = []
    for p in [*PORT_PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(p.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            bad += [f"{p.relative_to(ROOT)}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "repas_tpu", "jaxlib")]
    assert not bad


CLIS = sorted(p.stem for p in (PORT_PKG / "apps").glob("*.py")
              if not p.stem.startswith("_"))
# the fewest arguments each CLI parses (inputs need not exist: the device
# is resolved before any file is read)
ARGV = {"align_depth": ["--depth", "d", "--depth-intrinsics", "k",
                        "--color-intrinsics", "k", "--width", "8",
                        "--height", "8", "--out", "o"],
        "apply_6dof": ["--pose", "p", "--cad", "c", "--out", "o"],
        "calibrate": ["--images", "i", "--out", "o"],
        "capture_aligned": ["--source", "s", "--out", "o"],
        "crop_scene": ["--color", "c", "--depth", "d", "--out", "o"],
        "detect_canopy": ["--color", "c", "--depth", "d"],
        "detect_tags": ["i.png"],
        "error_report": ["surface", "--cloud", "c", "--mesh", "m"],
        "estimate_pose": ["--color", "c"],
        "fetch_intrinsics": ["--list"],
        "fuse_views": ["--views", "v", "--out", "o"],
        "generate_pointcloud": ["--color", "c", "--depth", "d", "--out",
                                "o"],
        "pack_replay": ["--input", "i", "--out", "o"],
        "place_cad": ["--color", "c", "--depth", "d", "--cad", "c",
                      "--out", "o"],
        "ply_to_stl": ["i.ply", "o.stl"],
        "refine_icp": ["--source", "s", "--target", "t", "--out", "o"],
        "track_stream": ["--source", "s"],
        "validate_pose": ["manual", "--color", "c", "--pose", "p"],
        "view_pointcloud": ["i.ply", "--out", "o"]}


def test_nineteen_clis():
    assert CLIS == sorted(ARGV) and len(CLIS) == 19
    assert CLIS == sorted(p.stem for p in (JAX_PKG / "apps").glob("*.py")
                          if not p.stem.startswith("_"))


@pytest.mark.parametrize("name", CLIS)
def test_cli_defaults_to_cuda_and_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repas_tpu_torch.apps.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(ARGV[name])


# --- jax.jit: every site of the JAX package has a compiled counterpart ----

def _jit_sites():
    """{"path:line": function name} of every function of the JAX package
    decorated with jax.jit (directly or through functools.partial), the
    line being the decorator's."""
    sites = {}
    for p in sorted(JAX_PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.FunctionDef):
                for dec in node.decorator_list:
                    if "jax.jit" in ast.unparse(dec):
                        sites[f"{p.relative_to(JAX_PKG)}:{dec.lineno}"] = \
                            node.name
    return sites


JIT_SITES = _jit_sites()

# site -> (port module, attribute path) of the compiled step
# (core.jit.Jitted) that is the site's counterpart. A kernel-level jit
# whose port is a hand-written kernel (B1, B3, B4) names the compiled
# step that runs that kernel; a jit of a function that the port runs as
# several graphs names the step that runs its device work
COMPILED = {
    "calib/checkerboard.py:141": ("calib.checkerboard",
                                  "refine_corners_subpix"),
    "calib/checkerboard.py:290": ("calib.checkerboard", "_lm_step"),
    "canopy/bar.py:31": ("canopy.bar", "canny_edges"),
    "canopy/bar.py:85": ("canopy.bar", "hough_horizontal_bar"),
    "canopy/segment.py:46": ("canopy.segment", "refine_plant_mask"),
    "cloud/filters.py:26": ("cloud.filters", "voxel_downsample"),
    "cloud/filters.py:84": ("cloud.filters", "compact_masked"),
    "cloud/fpfh.py:26": ("cloud.fpfh", "fpfh_features"),
    "cloud/fpfh.py:123": ("cloud.fpfh", "match_features"),
    "cloud/fpfh.py:165": ("cloud.fpfh", "_ransac_from_picks"),
    "cloud/generate.py:26": ("cloud.generate", "_back_project"),
    "cloud/knn.py:43": ("cloud.knn", "_grid_hash_build"),
    "cloud/knn.py:95": ("cloud.knn", "grid_hash_query"),
    "cloud/knn.py:188": ("cloud.knn", "grid_hash_query_knn"),
    "cloud/normals.py:13": ("cloud.normals", "_normals_grid"),
    "cloud/normals.py:67": ("cloud.normals", "_normals_step"),
    "cloud/reconstruct.py:31": ("cloud.reconstruct", "_poisson"),
    "cloud/registration.py:35": ("cloud.registration", "_icp"),
    "detect/detector.py:471": ("detect.detector", "detect_tags_jit"),
    "detect/robust.py:72": ("detect.robust", "_enhance_stack"),
    "detect/robust.py:87": ("detect.robust", "_detect_batch"),
    "detect/robust.py:92": ("detect.robust", "_merge_jit"),
    "detect/robust.py:165": ("detect.robust", "_stage_a"),
    "detect/robust.py:187": ("detect.robust", "_stage_b"),
    "detect/robust.py:267": ("detect.robust", "_stage_c"),
    "eval/reports.py:160": ("eval.reports", "point_to_mesh_distances"),
    "eval/reports.py:196": ("eval.reports",
                            "point_to_mesh_signed_distances"),
    "kernels/align.py:24": ("kernels.align", "align_depth_to_color"),
    "kernels/ccl.py:46": ("pipeline", "process_frames_jit"),          # B1
    "kernels/ccl_pallas.py:157": ("detect.robust", "_stage_c"),       # B4
    "kernels/ccl_pallas.py:229": ("pipeline", "process_frames_jit"),  # B1
    "kernels/color.py:32": ("kernels.color", "nv12_to_rgb"),
    "kernels/color.py:45": ("kernels.color", "yuyv_to_rgb"),
    "kernels/pointcloud.py:64": ("pipeline", "process_frames_jit"),   # B3
    "parallel/mesh.py:49": ("parallel.mesh", "sharded_frame_pipeline"),
    "pipeline.py:35": ("pipeline", "process_frames_jit"),
    "pose/bundle.py:22": ("pose.bundle", "solve_tag_bundle_jit"),
    "pose/fusion.py:44": ("pose.fusion", "fuse_tag_poses_jit"),
    "pose/pnp.py:168": ("pose.pnp", "solve_pnp_ippe_square_jit"),
    "pose/pnp.py:212": ("pose.pnp", "detector_pose"),
    "pose/pnp.py:288": ("pose.pnp", "refine_pnp_gn_jit"),
    "pose/pnp.py:388": ("pose.pnp", "solve_pnp_sqpnp_jit"),
    "pose/pnp.py:476": ("pose.pnp", "solve_pnp_best_order_jit"),
    "pose/track.py:72": ("pose.track", "TagTracker._track"),
    "viz/render.py:25": ("viz.render", "render_pointcloud"),
}
# sites still run eagerly when called on their own: none. The seven that
# the eager process_frames (or another plain function) also calls are
# compiled as steps named ``<name>_jit`` beside their plain functions,
# which stay plain (see PLAIN_BESIDE)
PENDING = set()
# site -> the plain function beside its ``<name>_jit`` step: not
# compiled, so an eager caller captures no graph of its own
PLAIN_BESIDE = {site: JIT_SITES[site] for site, (_, path) in COMPILED.items()
                if path == f"{JIT_SITES[site]}_jit"}


def _compiled_steps(site):
    """The compiled steps COMPILED names for `site`."""
    mod, path = COMPILED[site]
    obj = importlib.import_module(f"repas_tpu_torch.{mod}")
    if path == "sharded_frame_pipeline":       # one step per shard
        return obj.sharded_frame_pipeline(lambda x: x, obj.frames_mesh(
            devices=["cpu", "cpu"])).steps
    for name in path.split("."):
        obj = getattr(obj, name)
    return [obj]


def test_jit_sites_are_listed_once():
    assert len(JIT_SITES) == 45
    assert not PENDING & set(COMPILED)
    assert set(JIT_SITES) == PENDING | set(COMPILED)


@pytest.mark.parametrize("site", sorted(JIT_SITES))
def test_every_jit_site_is_compiled_or_pending(site):
    from repas_tpu_torch.core.jit import Jitted

    if site in PENDING:
        # a pending site's port function is not compiled yet; once it is,
        # the site moves to COMPILED
        mod = importlib.import_module("repas_tpu_torch." + site.split(
            ":")[0][:-3].replace("/", "."))
        fn = getattr(mod, JIT_SITES[site])
        assert not isinstance(fn, Jitted), f"{site} is compiled: move it " \
            "from PENDING to COMPILED"
    else:
        steps = _compiled_steps(site)
        assert steps and all(isinstance(s, Jitted) for s in steps), site
        if site in PLAIN_BESIDE:
            mod = importlib.import_module(
                f"repas_tpu_torch.{COMPILED[site][0]}")
            plain = getattr(mod, PLAIN_BESIDE[site])
            assert not isinstance(plain, Jitted) and steps[0].fn is plain
