"""The port's capture-side and viewing CLIs against the JAX package's:
align_depth, capture_aligned (with --colorize), fetch_intrinsics (a
bundle and --list), pack_replay (.npz streams and a capture directory,
with --colorize) and view_pointcloud (--splat orbit renders, --html,
--depth-preview, --axes, --max-dist), on small synthetic inputs
(tests/test_apps_streaming.py's alignment case;
tests/test_torch_stream_scenes.py's captures and a cloud of one).

Every output file is held byte-identical: the aligned depth PNG (no
source pixel here projects within an ulp of a pixel edge, ROADMAP C),
the colour, depth, JET-preview PNGs and the depth NPY, the full-frame
point-cloud PLY, the intrinsics bundle, the 1280x720 splat renders (the
renderer is exact on the CPU, tests/test_torch_render.py), the HTML
viewer and the matplotlib views; and every sidecar equal but for its
timestamp.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repas_tpu_torch.io.image import write_depth_png  # noqa: E402
from repas_tpu_torch.io.ply import PointCloud, write_ply  # noqa: E402
from test_torch_stream_scenes import (render_view, run_both,  # noqa: E402
                                      write_frame, write_intrinsics,
                                      write_stream)


def _same_tree(ref, port):
    """Every file under ref equals its counterpart under port (sidecar
    JSONs without their timestamps); returns the relative paths."""
    names = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(port) for p in port.rglob("*")
                           if p.is_file())
    for n in names:
        a, b = (ref / n).read_bytes(), (port / n).read_bytes()
        if "meta" in n.name and n.suffix == ".json":
            a, b = json.loads(a), json.loads(b)
            a.pop("timestamp"), b.pop("timestamp")
        assert a == b, n
    return [str(n) for n in names]


@pytest.mark.parametrize("extra", [[], ["--no-fill"]], ids=["fill", "no_fill"])
def test_align_depth_cli_matches_reference(tmp_path, extra):
    rng = np.random.default_rng(0)
    depth = (0.8 + 0.05 * rng.standard_normal((120, 160))).astype(np.float32)
    depth[40:60, 50:90] = 0.0                       # a hole to fill
    write_depth_png(tmp_path / "d.png", depth)
    (tmp_path / "dk.json").write_text(json.dumps(
        {"fx": 100.0, "fy": 100.0, "cx": 80.0, "cy": 60.0,
         "width": 160, "height": 120}))
    (tmp_path / "ck.json").write_text(json.dumps(
        {"fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 120.0,
         "width": 320, "height": 240}))
    (tmp_path / "ext.json").write_text(json.dumps(
        {"R": [[0.9998477, 0, 0.0174524], [0, 1, 0],
               [-0.0174524, 0, 0.9998477]], "t": [0.015, 0.0, 0.0]}))
    ref, port, _, _ = run_both(
        "align_depth", ["--depth", str(tmp_path / "d.png"),
                        "--depth-intrinsics", str(tmp_path / "dk.json"),
                        "--color-intrinsics", str(tmp_path / "ck.json"),
                        "--extrinsics", str(tmp_path / "ext.json"),
                        "--width", "320", "--height", "240",
                        "--out", "{out}/aligned.png", *extra],
        tmp_path, ["aligned.png"])
    assert _same_tree(ref, port) == ["aligned.png"]


def test_capture_aligned_cli_matches_reference(tmp_path):
    src = write_stream(tmp_path / "src", 2)
    ref, port, _, _ = run_both(
        "capture_aligned", ["--source", str(src), "--intrinsics",
                            str(write_intrinsics(tmp_path / "K.json")),
                            "--out", "{out}/caps", "--colorize"], tmp_path)
    names = _same_tree(ref, port)
    assert len(names) == 2 * 6
    assert {n.split("/")[-1].split("_2025")[0] for n in names} == {
        "color", "aligned_depth", "aligned_depth_m", "depth_cm",
        "pointcloud", "capture_meta"}


def test_fetch_intrinsics_cli_matches_reference(tmp_path):
    K = write_intrinsics(tmp_path / "K.json")
    (tmp_path / "ext.json").write_text(json.dumps(
        {"R": np.eye(3).tolist(), "t": [0.015, 0.0, 0.0]}))
    ref, port, _, _ = run_both(
        "fetch_intrinsics", ["--color", str(K), "--depth", str(K),
                             "--extrinsics", str(tmp_path / "ext.json"),
                             "--out", "{out}/bundle.json"], tmp_path,
        ["bundle.json"])
    assert _same_tree(ref, port) == ["bundle.json"]
    write_stream(tmp_path / "src", 1)
    for src in (tmp_path / "src", tmp_path / "empty"):
        run_both("fetch_intrinsics", ["--source", str(src), "--list"],
                 tmp_path)
    with pytest.raises(SystemExit):
        run_both("fetch_intrinsics", ["--list"], tmp_path)


def test_pack_replay_cli_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    frames = [render_view(c=np.array([0.002 * k, 0, 0]), seed=k)
              for k in range(2)]
    np.savez(tmp_path / "stream_mm.npz",
             color=np.stack([f[0] for f in frames]),
             depth=np.stack([np.round(f[1] * 1000).astype(np.uint16)
                             for f in frames]),
             timestamps=np.array(["20250101_000000", "20250101_000001"]))
    np.savez(tmp_path / "stream_m.npz",
             color=np.stack([f[0] for f in frames]),
             depth=np.stack([f[1] + rng.normal(0, 1e-4, f[1].shape)
                             .astype(np.float32) for f in frames]),
             timestamps=np.array(["20250102_000000", "20250102_000001"]))
    rgb, depth = render_view(seed=9)
    write_frame(tmp_path / "messy" / "sub", "2025-01-03T090909", rgb, depth,
                color="color", depth_name="aligned_depth")
    for i, src in enumerate((tmp_path / "stream_mm.npz",
                             tmp_path / "stream_m.npz", tmp_path / "messy")):
        d = tmp_path / f"run{i}"
        ref, port, _, _ = run_both(
            "pack_replay", ["--input", str(src), "--out", "{out}/packed",
                            "--colorize"], d)
        names = _same_tree(ref / "packed", port / "packed")
        assert "replay_meta.json" in names
        assert sum(n.startswith("depth_cm_") for n in names) == \
            sum(n.startswith("rgb_") for n in names) >= 1


@pytest.mark.parametrize("extra,n_files", [
    (["--splat", "--orbit", "2", "--html", "{out}/viewer.html"], 3),
    (["--splat", "--orbit", "1", "--depth-preview", "--max-dist", "0.5"], 1),
    (["--axes", "--max-points", "3000"], 3)],
    ids=["splat_html", "depth_preview", "matplotlib"])
def test_view_pointcloud_cli_matches_reference(tmp_path, extra, n_files):
    rgb, depth = render_view(seed=3)
    v, u = np.mgrid[0:240:2, 0:320:2]
    z = depth[v, u]
    pts = np.stack([(u - 160.0) / 260.0 * z, (v - 120.0) / 260.0 * z, z],
                   -1).reshape(-1, 3)
    write_ply(tmp_path / "scene.ply",
              PointCloud(points=pts.astype(np.float32),
                         colors=rgb[v, u].reshape(-1, 3) / 255.0))
    ref, port, _, _ = run_both(
        "view_pointcloud", [str(tmp_path / "scene.ply"), "--out",
                            "{out}/view", *extra], tmp_path)
    assert len(_same_tree(ref, port)) == n_files
