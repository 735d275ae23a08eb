"""The port's CLIs (``repas_tpu_torch.apps``) against the JAX package's on
one 240x320 capture: tags 9 and 16 on a plane at 0.45 m, two bumps of
unequal size in front of the plane below tag 16 (relief that pins ICP in
every direction), u16 depth with noise.

Each app runs as the JAX app and as the port app (``--device cpu``) on
the same input files; the port's sampled normals are fed the reference's
own sample (``PRNGKey(1)``), so the outputs compare at these tolerances:
- clouds (generate_pointcloud, crop_scene): the full-frame PLY
  byte-identical; otherwise the same point count, points within 1e-6,
  colours within one 8-bit level on at most 1 % of points (a voxel's mean
  colour within an ulp of a .5 level), normals within 1e-4 (1 % of points
  allowed more: grazing neighbourhoods, as in
  ``test_torch_cloud_crop_generate``);
- the fused pose (crop_scene, place_cad): tag ids equal, R within 0.25
  degrees (XLA's FMAs move the refined corners by hundredths of a pixel,
  ROADMAP C; measured 0.07 degrees on tag 16 alone), the depth-corrected
  anchor within 1e-6 m, the crop's box within 1 mm;
- place_cad: the scale and translation steps equal, the rotation step's
  R within 0.25 degrees, ICP fitness within 1e-3, the placed CAD within
  1 mm of the reference's pointwise; apply_6dof and refine_icp on
  identical inputs: T within 0.05 mm and 0.01 degrees, fitness within
  1e-6. Iterations are not compared: ICP stops when two RMSEs agree to
  1e-6 relative, and near its fixed point one correspondence can flip
  back and forth at rounding level, so one side may cycle to max_iters
  (measured on apply_6dof: the port 100, the reference 6, T 0.016 mm
  apart; ROADMAP C);
- ply_to_stl: alpha and bpa STLs byte-identical; poisson (its normals
  from the sampled estimator, whose k-th neighbour on this grid of
  quantized depths is decided by ties and by XLA's FMAs: 4 % of the
  normals differ by up to 0.03) triangle counts within 1 %, every vertex
  within a grid cell of the other mesh (test_torch_reconstruct.py holds
  chi itself to 1e-5 on identical normals).
``refine_icp --global`` draws RANSAC hypotheses from a torch generator,
so it is held to the known transform instead (within 1 mm and 0.5
degrees after ICP). Every sidecar's ``kind`` and ``generator`` equal the
reference's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.detect.render import render_tag_in_scene  # noqa: E402
from repas_tpu.io.image import write_depth_png, write_image  # noqa: E402
from repas_tpu.io.ply import read_geometry as j_read  # noqa: E402
from repas_tpu_torch.cloud import cad as TC, generate as TG  # noqa: E402
from repas_tpu_torch.cloud import normals as TN  # noqa: E402
from repas_tpu_torch.io.ply import (PointCloud, read_geometry,  # noqa: E402
                                    write_ply)
from repas_tpu_torch.io.pose_txt import save_transform_txt  # noqa: E402

FX, CX, CY, H, W = 260.0, 160.0, 120.0, 240, 320
Z0, TAG = 0.45, 0.07
TAGS = {9: (-0.10, -0.04), 16: (0.09, -0.04)}
BUMPS = ((0.06, 0.08, 0.02, 0.03),       # centre x, y, sigma, height (m)
         (0.13, 0.11, 0.015, 0.02))
CROP = ["--dx", "0.1", "0.1", "--dy", "0.2", "0.05", "--dz", "0.01",
        "0.06", "--tag-size", str(TAG)]


def _depth():
    """z per pixel of the plane z = Z0 with Gaussian bumps toward the
    camera (a fixed point along each pixel's ray)."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    z = np.full((H, W), Z0)
    for _ in range(20):
        x, y = (u - CX) / FX * z, (v - CY) / FX * z
        z = Z0 - sum(hgt * np.exp(-((x - bx) ** 2 + (y - by) ** 2)
                                  / (2 * s * s)) for bx, by, s, hgt in BUMPS)
    return z


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("capture")
    K = np.array([[FX, 0, CX], [0, FX, CY], [0, 0, 1.0]])
    img = np.full((H, W), 180.0, np.float32)
    for tid, (x, y) in TAGS.items():
        # tag 9 is mounted upside down: the fusion's flip makes both agree
        R = np.diag([-1.0, -1.0, 1.0]) if tid == 9 else np.eye(3)
        g = render_tag_in_scene(tid, R, np.array([x, y, Z0]), K, TAG,
                                (H, W), supersample=2)
        img = np.where(g != 180.0, g, img)
    rng = np.random.default_rng(0)
    rgb = np.clip(np.repeat(img[..., None], 3, -1)
                  + rng.normal(0, 2, (H, W, 3)), 0, 255).astype(np.uint8)
    write_image(d / "rgb.png", rgb)
    depth = _depth() + rng.normal(0, 0.0005, (H, W))
    write_depth_png(d / "depth.png", depth.astype(np.float32))
    (d / "K.json").write_text(json.dumps(
        {"fx": FX, "fy": FX, "cx": CX, "cy": CY, "width": W, "height": H}))
    return d


def _fed_normals(pts, mask, k=30, radius=0.02, sample=4096, camera=None,
                 key=None):
    """The port's sampled normals on the reference's own sample."""
    n = pts.shape[0]
    probs = jnp.asarray(mask.cpu().numpy(), jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = np.array(jax.random.choice(
        jax.random.PRNGKey(1) if key is None else key, n,
        shape=(min(sample, n),), p=probs, replace=False))
    return TN._normals_from_sample(pts, mask, torch.from_numpy(idx).long(),
                                   k, radius, camera)


@pytest.fixture
def fed(monkeypatch):
    for mod in (TG, TC, TN):
        monkeypatch.setattr(mod, "estimate_normals", _fed_normals)


def _both(name, args, tmp_path, outs):
    """Run the JAX app and the port app (--device cpu) with `args`, where
    each "{out}" becomes <tmp>/ref or <tmp>/port. Returns the two dirs."""
    import importlib

    dirs = []
    for pkg, extra in (("repas_tpu", []), ("repas_tpu_torch",
                                           ["--device", "cpu"])):
        d = tmp_path / ("ref" if pkg == "repas_tpu" else "port")
        d.mkdir(exist_ok=True)
        mod = importlib.import_module(f"{pkg}.apps.{name}")
        mod.main([a.replace("{out}", str(d)) for a in args] + extra)
        for o in outs:
            assert (d / o).exists(), (pkg, o)
        dirs.append(d)
    return dirs


def _meta(d, name):
    m = json.loads((d / name).read_text())
    m.pop("timestamp")
    return m


def _angle_deg(Ra, Rb):
    Rr = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    return float(np.degrees(np.arctan2(np.linalg.norm(w),
                                       (np.trace(Rr) - 1) / 2)))


def _same_T(Tt, Tj, scale=1.0):
    """ICP results on identical inputs: within 0.05 mm and 0.01 degrees
    (the converging step is decided on an f32 RMSE at rounding level)."""
    Tt, Tj = np.asarray(Tt), np.asarray(Tj)
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 5e-5
    assert _angle_deg(Tt[:3, :3] / scale, Tj[:3, :3] / scale) <= 0.01


def _same_cloud(ref, port, normals_tol=None):
    a, b = j_read(ref), read_geometry(port)
    assert len(a) == len(b) > 100
    np.testing.assert_allclose(b.points, a.points, rtol=0, atol=1e-6)
    # a voxel's mean colour within an ulp of a .5 level rounds either way
    dc = np.abs(b.colors - a.colors)
    assert dc.max() <= 1 / 255 + 1e-9 and (dc > 0).any(1).mean() <= 0.01
    if normals_tol is not None:
        off = np.abs(b.normals - a.normals).max(axis=1) > normals_tol
        assert off.sum() <= 0.01 * len(a)
    return a, b


def test_generate_pointcloud_cli(scene, tmp_path, fed):
    base = ["--color", str(scene / "rgb.png"), "--depth",
            str(scene / "depth.png"), "--intrinsics", str(scene / "K.json")]
    ref, port = _both("generate_pointcloud",
                      base + ["--out", "{out}/full.ply"], tmp_path,
                      ["full.ply"])
    assert (port / "full.ply").read_bytes() == (ref / "full.ply").read_bytes()
    ref, port = _both("generate_pointcloud",
                      base + ["--out", "{out}/vox.ply", "--voxel", "0.005",
                              "--normals", "--max-dist", "0.6"],
                      tmp_path, ["vox.ply"])
    _same_cloud(ref / "vox.ply", port / "vox.ply", normals_tol=1e-4)
    mj, mt = _meta(ref, "vox.meta.json"), _meta(port, "vox.meta.json")
    assert mt["kind"] == "capture" and mt["generator"] == "repas_tpu"
    for k in ("source_color", "source_depth"):
        mj.pop(k), mt.pop(k)
    assert mt == mj


@pytest.fixture(scope="module")
def crops(scene, tmp_path_factory):
    """crop_scene's outputs from both apps (reference dir, port dir)."""
    return _both("crop_scene",
                 ["--color", str(scene / "rgb.png"), "--depth",
                  str(scene / "depth.png"), "--intrinsics",
                  str(scene / "K.json"), "--out", "{out}/crop.ply", *CROP],
                 tmp_path_factory.mktemp("crop"), ["crop.ply"])


def test_crop_scene_cli(crops):
    ref, port = crops
    _same_cloud(ref / "crop.ply", port / "crop.ply")
    mj, mt = _meta(ref, "crop.meta.json"), _meta(port, "crop.meta.json")
    assert mt["kind"] == "crop" and mt["tag_ids"] == mj["tag_ids"]
    assert sorted(mt["tag_ids"]) == [9, 16]
    assert mt["n_points"] == mj["n_points"] > 1000
    assert _angle_deg(mt["R_anchor"], mj["R_anchor"]) < 0.25
    np.testing.assert_allclose(mt["anchor_P_depth"], mj["anchor_P_depth"],
                               rtol=0, atol=1e-6)
    for k in ("aabb_lo", "aabb_hi", "box_corners_cam"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    assert abs(mt["anchor_P_depth"][2] - Z0) < 0.003
    assert mt["offsets"] == mj["offsets"]


def test_place_cad_apply_6dof_and_refine_icp_clis(scene, crops, tmp_path,
                                                   fed):
    crop_ply = crops[0] / "crop.ply"
    crop = read_geometry(crop_ply)
    cm = _meta(crops[0], "crop.meta.json")
    R = np.asarray(cm["R_anchor"])
    P = np.asarray(cm["anchor_P_depth"])
    pts = np.asarray(crop.points, np.float64)
    sel = np.arange(len(pts))[::4]
    cad = (R.T @ (pts[sel] - P).T).T / 0.001                 # tag frame, mm
    write_ply(tmp_path / "cad.ply", PointCloud(points=cad.astype(np.float32)))

    ref, port = _both("place_cad",
                      ["--color", str(scene / "rgb.png"), "--depth",
                       str(scene / "depth.png"), "--intrinsics",
                       str(scene / "K.json"), "--cad",
                       str(tmp_path / "cad.ply"), "--out",
                       "{out}/placed.ply", "--tag-size", str(TAG),
                       "--tag-ids", "16", "--icp"],
                      tmp_path, ["placed.ply"])
    mj, mt = _meta(ref, "placed.meta.json"), _meta(port, "placed.meta.json")
    assert mt["kind"] == "cad_transform"
    assert mt["transform_order"] == mj["transform_order"] == [
        "scale_about_centroid", "rotate_Ravg_about_origin",
        "translate_origin_to_anchor", "icp_refinement"]
    steps_t, steps_j = mt["transforms"], mj["transforms"]
    for name in ("scale_about_centroid", "translate_origin_to_anchor"):
        np.testing.assert_allclose(steps_t[name], steps_j[name], rtol=0,
                                   atol=1e-7, err_msg=name)
    name = "rotate_Ravg_about_origin"
    assert _angle_deg(np.asarray(steps_t[name])[:3, :3],
                      np.asarray(steps_j[name])[:3, :3]) < 0.25
    icp_t, icp_j = mt["icp"], mj["icp"]
    assert abs(icp_t["fitness"] - icp_j["fitness"]) <= 1e-3
    assert icp_t["fitness"] > 0.9 and icp_t["delta_translation_mm"] < 5.0
    assert icp_t["delta_rotation_deg"] < 1.0
    np.testing.assert_allclose(mt["weights"], mj["weights"], rtol=1e-3)
    placed = read_geometry(port / "placed.ply").points
    assert np.abs(placed - j_read(ref / "placed.ply").points).max() < 1e-3
    assert np.median(np.linalg.norm(placed - pts[sel], axis=1)) < 0.005

    # apply_6dof: the placement as a pose txt, the CAD back onto the crop
    T = np.asarray(mj["T_cad_world"]) @ np.diag([1000.0, 1000, 1000, 1])
    save_transform_txt(tmp_path / "pose.txt", T)
    ref, port = _both("apply_6dof",
                      ["--pose", str(tmp_path / "pose.txt"), "--cad",
                       str(tmp_path / "cad.ply"), "--out", "{out}/posed.ply",
                       "--icp", "--scene", str(crop_ply)],
                      tmp_path, ["posed.ply"])
    mj, mt = _meta(ref, "posed.meta.json"), _meta(port, "posed.meta.json")
    assert mt["kind"] == "cad_transform"
    _same_T(mt["T_total"], mj["T_total"], scale=1e-3)
    assert abs(mt["icp"]["fitness"] - mj["icp"]["fitness"]) <= 1e-6

    # refine_icp without --global: the same inputs, the same result
    src = tmp_path / "moved.ply"
    th = np.radians(3.0)
    M = np.eye(4)
    M[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                 [0, 0, 1]]
    M[:3, 3] = [0.01, -0.008, 0.005]
    c = pts.mean(0)
    moved = (pts[sel] - c) @ M[:3, :3].T + c + M[:3, 3]
    write_ply(src, PointCloud(points=moved))
    ref, port = _both("refine_icp",
                      ["--source", str(src), "--target", str(crop_ply),
                       "--out",
                       "{out}/reg.ply", "--json", "{out}/reg.json"],
                      tmp_path, ["reg.ply", "reg.json"])
    rj = json.loads((ref / "reg.json").read_text())
    rt = json.loads((port / "reg.json").read_text())
    _same_T(rt["T_total"], rj["T_total"])
    assert abs(rt["icp"]["fitness"] - rj["icp"]["fitness"]) <= 1e-6
    assert _meta(port, "reg.meta.json")["kind"] == "cad_transform"

    # refine_icp --global (the port only): the known transform recovered
    from repas_tpu_torch.apps import refine_icp

    refine_icp.main(["--source", str(src), "--target", str(crop_ply),
                     "--out",
                     str(tmp_path / "g.ply"), "--json",
                     str(tmp_path / "g.json"), "--global",
                     "--device", "cpu"])
    g = json.loads((tmp_path / "g.json").read_text())
    Tg = np.asarray(g["T_total"])
    back = np.eye(4)
    back[:3, :3] = M[:3, :3].T
    back[:3, 3] = c - M[:3, :3].T @ (c + M[:3, 3])
    assert np.abs(Tg[:3, 3] - back[:3, 3]).max() < 1e-3
    assert _angle_deg(Tg[:3, :3], back[:3, :3]) < 0.5
    assert 0 < g["global"]["fitness"] <= 1


def test_ply_to_stl_cli(crops, tmp_path, fed):
    pc = read_geometry(crops[0] / "crop.ply")
    crop = str(tmp_path / "crop3.ply")          # every third point
    write_ply(crop, PointCloud(points=pc.points[::3], colors=pc.colors[::3]))
    for method, extra in (("alpha", []), ("bpa", []),
                          ("poisson", ["--dim", "48"])):
        r, p = _both("ply_to_stl", [crop, f"{{out}}/{method}.stl",
                                    "--method", method, *extra], tmp_path,
                     [f"{method}.stl"])
        mj = _meta(r, f"{method}.meta.json")
        mt = _meta(p, f"{method}.meta.json")
        assert mt["kind"] == "stl" and mt["method"] == mj["method"]
        a = (r / f"{method}.stl").read_bytes()
        b = (p / f"{method}.stl").read_bytes()
        if method != "poisson":
            assert mt == mj and mt["n_triangles"] > 100, method
            assert b == a, method
            continue
        # the crop's normals come from the sampled estimator, which differs
        # from the reference's on this tie-heavy grid of quantized depths
        # (4 % of normals by up to 0.03): counts within 1 %, every vertex
        # within a cell of the reference mesh
        from scipy.spatial import cKDTree

        assert abs(mt["n_triangles"] - mj["n_triangles"]) <= \
            0.01 * mj["n_triangles"]
        va, vb = (read_geometry(d / f"{method}.stl").vertices
                  for d in (r, p))
        pts = read_geometry(crop).points
        cell = float((pts.max(0) - pts.min(0)).max()) * 1.2 / 48
        assert cKDTree(va).query(vb)[0].max() <= cell
        assert cKDTree(vb).query(va)[0].max() <= cell


def test_port_clis_need_a_device_or_a_card(scene, tmp_path):
    from repas_tpu_torch.apps import generate_pointcloud, ply_to_stl

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_pointcloud.main(["--color", str(scene / "rgb.png"),
                                  "--depth", str(scene / "depth.png"),
                                  "--fx", str(FX), "--out",
                                  str(tmp_path / "x.ply")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ply_to_stl.main([str(tmp_path / "none.ply"),
                         str(tmp_path / "x.stl"), "--method", "alpha"])
