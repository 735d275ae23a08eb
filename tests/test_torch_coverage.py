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
