"""The port imports torch and numpy only: never jax, never repas_tpu, nor
the JAX repo's tools/ or __graft_entry__."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "repas_tpu_torch"


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def test_imports_with_jax_blocked():
    mods = [m for m, _ in _modules()]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'repas_tpu' "
        "or m.startswith('repas_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(mods) + "))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("module,path", list(_modules()),
                         ids=[m for m, _ in _modules()])
def test_no_jax_or_reference_imports(module, path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repas_tpu", "tools",
                               "__graft_entry__"), \
                f"{module} imports {name}"
