"""The port's CLIs detect_canopy, calibrate and error_report (both
subcommands) against the JAX package's apps on the same input files, the
port's with ``--device cpu``.

Tolerances, with what was measured (jax 0.9.0, torch 2.13 CPU):
- detect_canopy on a noisy 240x320 capture (tests/test_torch_scenes.py's
  tilted scene, u16 depth PNG): the JSON's bar_px, bar_3d and rotation
  exact, canopy_px within 1e-4 px, canopy_3d and the height within
  1e-6 m (measured exact); the --out-txt files byte-identical;
- calibrate on five rendered 640x480 boards of 9x7 corners
  (tests/test_torch_scenes.py's renderer): the same JSON keys, K within
  0.5 px, k1 within 0.01 and k2 within 0.1, the RMS within 1e-3 px (five
  views leave k2 weakly determined, both land near 5.6, and the f32 LM
  stops at slightly different points of that flat valley, ROADMAP C;
  measured K 0.066 px, k1 8.5e-4, k2 0.064, RMS 2.2e-7 px); the NPZ's
  arrays have the reference's keys, shapes and dtypes;
- error_report corr: the report, txt and CSV byte-identical;
- error_report surface on a closed UV sphere with points inside and
  outside: the JSON report within 1e-5 mm (its distances within 1e-7 m,
  tests/test_torch_eval.py), the txt report with the same lines (numbers
  printed to 1e-3 mm: equal), the coloured PLY's points equal and its
  colours within one 8-bit level.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repas_tpu.io.image import write_depth_png, write_image  # noqa: E402
from repas_tpu.io.ply import read_ply as j_read_ply  # noqa: E402
from repas_tpu_torch.io.ply import (PointCloud, TriangleMesh,  # noqa: E402
                                    read_ply, write_ply, write_stl)
from test_torch_scenes import (COLS, K_CAL, ROWS, board_pose,  # noqa: E402
                               render_view, tilted_scene, uv_sphere)


def _run(app, argv, port):
    mod = __import__(f"repas_tpu{'_torch' if port else ''}.apps.{app}",
                     fromlist=["main"])
    return mod.main(argv + (["--device", "cpu"] if port else []))


def test_detect_canopy_cli(tmp_path):
    rgb, depth = tilted_scene(6.0, 1)
    write_image(tmp_path / "c.png", rgb)
    write_depth_png(tmp_path / "d.png", depth)
    outs = {}
    for port in (False, True):
        tag = "t" if port else "j"
        argv = ["--color", str(tmp_path / "c.png"),
                "--depth", str(tmp_path / "d.png"), "--fx", "300",
                "--out-txt", str(tmp_path / f"z_{tag}.txt"),
                "--json", str(tmp_path / f"{tag}.json")]
        _run("detect_canopy", argv, port)
        outs[tag] = json.loads((tmp_path / f"{tag}.json").read_text())
    j, t = outs["j"], outs["t"]
    assert set(j) == set(t)
    for k in ("bar_px", "bar_3d", "rotation_deg"):
        assert t[k] == j[k], k
    np.testing.assert_allclose(t["canopy_px"], j["canopy_px"], atol=1e-4)
    np.testing.assert_allclose(t["canopy_3d"], j["canopy_3d"], atol=1e-6)
    assert abs(t["plant_height_m"] - j["plant_height_m"]) < 1e-6
    assert (tmp_path / "z_t.txt").read_bytes() == (tmp_path / "z_j.txt"
                                                   ).read_bytes()


def test_calibrate_cli(tmp_path):
    d = tmp_path / "views"
    rng = np.random.default_rng(3)
    for i in range(5):
        R, t = board_pose(rng.uniform(10, 40), rng.uniform(-25, 25),
                          rng.uniform(-15, 15), rng.uniform(0.45, 0.6),
                          rng.uniform(-0.04, 0.04), rng.uniform(-0.03, 0.03))
        img = render_view(K_CAL, np.array([-0.2, 0.07, 0.0, 0.0, 0.0]), R, t,
                          blur=0.8, seed=i)
        write_image(d / f"view_{i:02d}.png", img.astype(np.uint8))
    res = {}
    for port in (False, True):
        tag = "t" if port else "j"
        _run("calibrate", ["--images", str(d), "--cols", str(COLS),
                           "--rows", str(ROWS), "--square-mm", "12.7",
                           "--out", str(tmp_path / f"{tag}.json"),
                           "--npz", str(tmp_path / f"{tag}.npz")], port)
        res[tag] = (json.loads((tmp_path / f"{tag}.json").read_text()),
                    np.load(tmp_path / f"{tag}.npz"))
    (j, jz), (t, tz) = res["j"], res["t"]
    assert list(t) == list(j)
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(t[k] - j[k]) < 0.5, k
    for k in ("width", "height", "checkerboard_inner_corners",
              "square_size_mm"):
        assert t[k] == j[k], k
    assert abs(t["dist_coeffs"][0] - j["dist_coeffs"][0]) < 0.01
    assert abs(t["dist_coeffs"][1] - j["dist_coeffs"][1]) < 0.1
    assert abs(t["rms_px"] - j["rms_px"]) < 1e-3
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        assert tz[k].shape == jz[k].shape and tz[k].dtype == jz[k].dtype, k


def test_error_report_corr_cli(tmp_path):
    rng = np.random.default_rng(4)
    ref = rng.uniform(-0.2, 0.2, (6, 3))
    meas = ref + rng.normal(0, 0.004, (6, 3))
    for name, pts in (("ref", ref), ("meas", meas)):
        rows = "".join(f' <point x="{x}" y="{y}" z="{z}" name="p{i}"/>\n'
                       for i, (x, y, z) in enumerate(pts.tolist()))
        (tmp_path / f"{name}.pp").write_text(
            "<PickedPoints>\n" + rows + "</PickedPoints>\n")
    for port in (False, True):
        tag = "t" if port else "j"
        _run("error_report", ["corr", "--ref", str(tmp_path / "ref.pp"),
                              "--meas", str(tmp_path / "meas.pp"),
                              "--txt", str(tmp_path / f"{tag}.txt"),
                              "--csv", str(tmp_path / f"{tag}.csv"),
                              "--json", str(tmp_path / f"{tag}.json")],
             False)
    for ext in ("txt", "csv", "json"):
        assert ((tmp_path / f"t.{ext}").read_bytes()
                == (tmp_path / f"j.{ext}").read_bytes()), ext


def test_error_report_surface_cli(tmp_path):
    verts, tris = uv_sphere(16, 24)
    write_stl(tmp_path / "m.stl", TriangleMesh(vertices=verts,
                                               triangles=tris))
    rng = np.random.default_rng(5)
    d = rng.normal(size=(800, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * rng.uniform(0.095, 0.105, (800, 1))
    write_ply(tmp_path / "c.ply", PointCloud(points=pts.astype(np.float32)))
    for port in (False, True):
        tag = "t" if port else "j"
        _run("error_report", ["surface", "--cloud", str(tmp_path / "c.ply"),
                              "--mesh", str(tmp_path / "m.stl"),
                              "--txt", str(tmp_path / f"{tag}.txt"),
                              "--json", str(tmp_path / f"{tag}.json"),
                              "--colored-out",
                              str(tmp_path / f"{tag}.ply")], port)
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert "signed" in t and set(t) == set(j)

    def flat(r, pre=""):
        for k, v in r.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v
    jf, tf = dict(flat(j)), dict(flat(t))
    assert jf.keys() == tf.keys()
    for k in jf:
        assert abs(tf[k] - jf[k]) < 1e-5, k
    assert ((tmp_path / "t.txt").read_text().splitlines()
            == (tmp_path / "j.txt").read_text().splitlines())
    cj, ct = j_read_ply(tmp_path / "j.ply"), read_ply(tmp_path / "t.ply")
    np.testing.assert_array_equal(ct.points, cj.points)
    assert np.abs(np.asarray(ct.colors, float)
                  - np.asarray(cj.colors, float)).max() <= 1 / 255 + 1e-9
