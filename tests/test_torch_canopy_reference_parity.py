"""The port of tools/canopy_reference_parity.py against the JAX repo's
tool, loaded from its file, on synthetic canopy captures written as the
reference names them (tests/test_torch_scenes.py's tilted_scene at
240x320: colour PNG, u16 mm depth PNG, the truth as text).

Both make the same cv2 calls on the same inputs, so everything is held
exactly: main()'s printed output, reference_canopy's dict for 5 GrabCut
seeds, and None on a frame without a plant. Without cv2 the port's
module still imports and a call raises an ImportError naming cv2.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
from repas_tpu_torch.tools import (  # noqa: E402
    canopy_reference_parity as port)
from test_torch_scenes import tilted_scene  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAMPS = ["2025-11-14T143013", "2025-11-14T143028"]
SCENES = [(4.0, 0), (-3.0, 1)]        # bar angle (degrees), noise seed


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def jtool(cv2):
    spec = importlib.util.spec_from_file_location(
        "jax_tools_canopy_reference_parity",
        ROOT / "tools" / "canopy_reference_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(angle, seed):
    """(bgr uint8, depth u16 mm) of a tilted_scene capture."""
    rgb, depth_m = tilted_scene(angle, seed)
    depth = np.round(depth_m * 1000.0).astype(np.uint16)
    return np.ascontiguousarray(rgb[..., ::-1]), depth


@pytest.fixture(scope="module")
def captures(cv2, tmp_path_factory):
    d = tmp_path_factory.mktemp("canopy_captures")
    for stamp, (angle, seed) in zip(STAMPS, SCENES):
        bgr, depth = _capture(angle, seed)
        assert cv2.imwrite(str(d / f"canopy_capture_{stamp}_HD.png"), bgr)
        assert cv2.imwrite(str(d / f"depth_snapshot_{stamp}_HD.png"), depth)
        (d / f"canopy_y_{stamp}.txt").write_text(f"{-0.1 - seed * 0.01}\n")
    return d


def test_main_prints_what_the_tool_prints(jtool, captures, capsys,
                                          monkeypatch):
    monkeypatch.setattr(jtool, "BASE", str(captures))
    monkeypatch.setattr(jtool, "STAMPS", STAMPS)
    jtool.main()
    ref = capsys.readouterr().out
    assert port.main(["--captures", str(captures), "--stamps", *STAMPS]) == 0
    got = capsys.readouterr().out
    assert got == ref
    assert ref.count("truth=") == len(STAMPS)


def test_reference_canopy_equal_over_seeds(jtool):
    bgr, depth = _capture(*SCENES[0])
    for seed in range(5):
        ref = jtool.reference_canopy(bgr, depth, seed)
        got = port.reference_canopy(bgr, depth, seed)
        assert ref is not None and got == ref
        assert abs(got["z"] - 0.9) < 0.01


def test_plantless_frame_gives_none(jtool):
    rng = np.random.default_rng(3)
    bgr = np.clip(np.round(rng.normal(120, 3, (240, 320, 3))), 0, 255
                  ).astype(np.uint8)
    depth = np.full((240, 320), 2900, np.uint16)
    assert jtool.reference_canopy(bgr, depth, 0) is None
    assert port.reference_canopy(bgr, depth, 0) is None


def test_without_cv2_imports_and_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    mod = importlib.reload(port)
    try:
        with pytest.raises(ImportError, match="cv2"):
            mod.reference_canopy(np.zeros((8, 8, 3), np.uint8),
                                 np.zeros((8, 8), np.uint16), 0)
    finally:
        monkeypatch.undo()
        importlib.reload(port)
