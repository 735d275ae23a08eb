"""The port's host I/O (``io/ply.py``, ``io/meta.py``, ``io/pose_txt.py``,
``io/image.py``, ``io/native.py``) and ``core/calib.py`` against the JAX
package.

Files written by both packages from the same input must be byte-identical
(PLY ascii and binary, clouds and meshes, with and without colours and
normals; STL; pose txt; sidecar metadata minus its ``timestamp``); reads
and area-weighted sampling must be exactly equal. The native PNG codec,
built from ``native/repas_io.cpp`` at first use, must decode exactly as
PIL does.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.core import calib as JCal  # noqa: E402
from repas_tpu.io import image as JI, meta as JM, ply as JP  # noqa: E402
from repas_tpu.io import pose_txt as JT  # noqa: E402
from repas_tpu_torch.core import calib as TCal  # noqa: E402
from repas_tpu_torch.io import image as TI, meta as TM, native  # noqa: E402
from repas_tpu_torch.io import ply as TP, pose_txt as TT  # noqa: E402


def _geometry(mod, mesh, colors, normals, seed=0):
    rng = np.random.default_rng(seed)
    n = 300
    pts = rng.normal(size=(n, 3)) * [0.1, 0.2, 0.05] + [0, 0, 0.5]
    cols = rng.random((n, 3)) if colors else None
    nrm = rng.normal(size=(n, 3)) if normals else None
    if mesh:
        tri = rng.integers(0, n, (500, 3))
        return mod.TriangleMesh(vertices=pts, triangles=tri,
                                vertex_colors=cols, vertex_normals=nrm)
    return mod.PointCloud(points=pts.astype(np.float32), colors=cols,
                          normals=nrm)


@pytest.mark.parametrize("ascii_", [False, True], ids=["binary", "ascii"])
@pytest.mark.parametrize("mesh", [False, True], ids=["cloud", "mesh"])
@pytest.mark.parametrize("colors,normals", [(False, False), (True, False),
                                            (False, True), (True, True)],
                         ids=["xyz", "rgb", "normals", "rgb+normals"])
def test_write_ply_bytes_and_read_back(tmp_path, ascii_, mesh, colors,
                                       normals):
    pj, pt = tmp_path / "ref.ply", tmp_path / "port.ply"
    JP.write_ply(pj, _geometry(JP, mesh, colors, normals), ascii=ascii_)
    TP.write_ply(pt, _geometry(TP, mesh, colors, normals), ascii=ascii_)
    assert pt.read_bytes() == pj.read_bytes()
    gj, gt = JP.read_ply(pj), TP.read_ply(pt)
    assert type(gt).__name__ == type(gj).__name__
    for name, v in vars(gj).items():
        w = getattr(gt, name)
        if v is None:
            assert w is None, name
        else:
            np.testing.assert_array_equal(w, v, err_msg=name)


def test_stl_bytes_read_back_and_geometry(tmp_path):
    mj, mt = (_geometry(m, True, False, False, seed=3) for m in (JP, TP))
    JP.write_stl(tmp_path / "ref.stl", mj)
    TP.write_stl(tmp_path / "port.stl", mt)
    assert (tmp_path / "port.stl").read_bytes() == \
        (tmp_path / "ref.stl").read_bytes()
    rj, rt = JP.read_stl(tmp_path / "ref.stl"), TP.read_stl(
        tmp_path / "port.stl")
    np.testing.assert_array_equal(rt.vertices, rj.vertices)
    np.testing.assert_array_equal(rt.triangles, rj.triangles)
    ascii_stl = ("solid t\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\n"
                 "vertex 1 0 0\nvertex 0 1 0\nendloop\nendfacet\n"
                 "endsolid t\n")
    (tmp_path / "a.stl").write_text(ascii_stl)
    aj, at = JP.read_geometry(tmp_path / "a.stl"), TP.read_geometry(
        tmp_path / "a.stl")
    np.testing.assert_array_equal(at.vertices, aj.vertices)
    np.testing.assert_array_equal(at.triangles, aj.triangles)
    # the host geometry helpers
    T = np.array([[0, -1, 0, 0.1], [1, 0, 0, -0.2], [0, 0, 1, 0.3],
                  [0, 0, 0, 1.0]]) * [[2], [2], [2], [1]]
    for a, b in ((mj, mt), (_geometry(JP, False, True, True),
                            _geometry(TP, False, True, True))):
        for name, v in vars(a.transformed(T)).items():
            w = getattr(b.transformed(T), name)
            np.testing.assert_array_equal(w, v, err_msg=name)
    np.testing.assert_array_equal(mt.compute_vertex_normals(),
                                  mj.compute_vertex_normals())


@pytest.mark.parametrize("n,seed", [(5000, 0), (777, 12)])
def test_sample_points_uniformly_exact(n, seed):
    mj, mt = (_geometry(m, True, False, False, seed=1) for m in (JP, TP))
    np.testing.assert_array_equal(
        mt.sample_points_uniformly(n, seed=seed).points,
        mj.sample_points_uniformly(n, seed=seed).points)


def test_pose_txt_bytes_and_rejections(tmp_path):
    th = 0.3
    T = np.array([[np.cos(th), -np.sin(th), 0, 0.1],
                  [np.sin(th), np.cos(th), 0, -0.25],
                  [0, 0, 1, 0.6], [0, 0, 0, 1]])
    JT.save_transform_txt(tmp_path / "ref.txt", T)
    TT.save_transform_txt(tmp_path / "port.txt", T)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()
    np.testing.assert_array_equal(TT.load_transform_txt(tmp_path / "ref.txt"),
                                  JT.load_transform_txt(tmp_path / "ref.txt"))
    bad = {"scaled": T * [[1.1], [1.1], [1.1], [1]],
           "skewed": T + [[0, 0.05, 0, 0], [0] * 4, [0] * 4, [0] * 4],
           "last_row": T + [[0] * 4, [0] * 4, [0] * 4, [0, 0, 0.5, 0]]}
    for name, M in bad.items():
        path = tmp_path / f"{name}.txt"
        np.savetxt(path, M)
        with pytest.raises(ValueError) as ej:
            JT.load_transform_txt(path)
        with pytest.raises(ValueError) as et:
            TT.load_transform_txt(path)
        assert str(et.value) == str(ej.value)
        np.testing.assert_array_equal(
            TT.load_transform_txt(path, validate=False), M)
    np.savetxt(tmp_path / "3x4.txt", T[:3])
    with pytest.raises(ValueError, match="expected 4x4"):
        TT.load_transform_txt(tmp_path / "3x4.txt")


def test_meta_equal_but_timestamp(tmp_path):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    fields = dict(cad=tmp_path / "cad.ply", n=np.int64(5),
                  w=np.float32(0.25), nested={"a": [arr, (1, 2)]},
                  icp=None)
    mj = JM.write_meta(tmp_path / "ref.meta.json", "cad_transform",
                       T=jnp.asarray(arr), **fields)
    mt = TM.write_meta(tmp_path / "port.meta.json", "cad_transform",
                       T=torch.from_numpy(arr), **fields)
    for d in (mj, mt):
        assert d.pop("timestamp")
    assert mt == mj
    rj = JM.read_meta(tmp_path / "ref.meta.json")
    rt = TM.read_meta(tmp_path / "port.meta.json")
    rj.pop("timestamp"), rt.pop("timestamp")
    assert json.dumps(rt, indent=2) == json.dumps(rj, indent=2)
    assert rt["generator"] == "repas_tpu"
    assert len(TM.timestamp()) == len(JM.timestamp()) == 17


def test_intrinsics_every_schema(tmp_path):
    lean = {"fx": 610.5, "fy": 611.25, "cx": 321.0, "cy": 239.5,
            "width": 640, "height": 480}
    rs = {"fx": 910.0, "fy": 909.0, "ppx": 640.5, "ppy": 360.25,
          "width": 1280, "height": 720, "coeffs": [0.1, -0.2, 0.001, 0.0,
                                                   0.05],
          "distortion_model": "inverse_brown_conrady"}
    checker = {**lean, "dist_coeffs": [-0.24, 0.09, 0.001, -0.0008, 0.018,
                                       0.0, 0.0, 0.0, 0.5],
               "checkerboard_inner_corners": [9, 6], "square_size_mm": 25}
    bundle = {"color_intrinsics": rs, "depth_intrinsics": lean,
              "extrinsics": {"depth_to_color": {"R": np.eye(3).tolist(),
                                                "t": [0.015, 0, 0]}}}
    files = {}
    for name, d in (("lean", lean), ("rs", rs), ("checker", checker),
                    ("bundle", bundle)):
        files[name] = tmp_path / f"{name}.json"
        files[name].write_text(json.dumps(d))
    np.savez(tmp_path / "cal.npz", K=JCal.build_K(700, 701, 320, 240),
             dist=np.array([[0.1, 0.01, 0, 0, 0.001]]),
             image_size=np.array([640, 480]))

    def same(a, b):
        assert vars(a).keys() == vars(b).keys()
        for k in vars(a):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))

    for name, path in files.items():
        for stream in ("color", "depth"):
            same(TCal.load_intrinsics_json(path, stream),
                 JCal.load_intrinsics_json(path, stream))
    same(TCal.load_calibration_npz(tmp_path / "cal.npz"),
         JCal.load_calibration_npz(tmp_path / "cal.npz"))
    for ext in ({"R": np.eye(3).tolist(), "t": [1, 2, 3]},
                {"R_dc": np.eye(3).tolist(), "t_dc": [0.1, 0, 0]}, bundle):
        (tmp_path / "e.json").write_text(json.dumps(ext))
        ej = JCal.load_extrinsics_json(tmp_path / "e.json")
        et = TCal.load_extrinsics_json(tmp_path / "e.json")
        np.testing.assert_array_equal(et.T, ej.T)
        np.testing.assert_array_equal(et.inverse().T, ej.inverse().T)
    intr_j = JCal.load_intrinsics_json(files["rs"])
    intr_t = TCal.load_intrinsics_json(files["rs"])
    same(intr_t.scaled(640, 360), intr_j.scaled(640, 360))
    np.testing.assert_array_equal(intr_t.K, intr_j.K)
    assert TCal.scale_intrinsics(1, 2, 3, 4, 10, 10, 20, 5) == \
        JCal.scale_intrinsics(1, 2, 3, 4, 10, 10, 20, 5)
    for schema in ("lean", "realsense"):
        JCal.save_intrinsics_json(intr_j, tmp_path / "j.json", schema,
                                  extra={"rms_px": 0.2})
        TCal.save_intrinsics_json(intr_t, tmp_path / "t.json", schema,
                                  extra={"rms_px": 0.2})
        assert (tmp_path / "t.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
    (tmp_path / "bad.json").write_text(json.dumps({"fx": 1.0}))
    with pytest.raises(KeyError, match="fy"):
        TCal.load_intrinsics_json(tmp_path / "bad.json")


def test_native_png_codec_matches_pil(tmp_path):
    from PIL import Image

    assert native.available(), native.build_error
    rng = np.random.default_rng(0)
    imgs = {"rgb": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
            "gray": rng.integers(0, 256, (20, 31), dtype=np.uint8),
            "rgba": rng.integers(0, 256, (9, 14, 4), dtype=np.uint8),
            "depth": rng.integers(0, 65536, (41, 29), dtype=np.uint16)}
    # a smooth image makes PIL's encoder pick several filter types
    yy, xx = np.mgrid[0:64, 0:96]
    imgs["smooth"] = np.stack([xx * 2, yy * 3, xx + yy], -1).astype(np.uint8)
    for name, arr in imgs.items():
        path = tmp_path / f"{name}.png"
        Image.fromarray(arr).save(path)
        got = native.read_png(path)
        want = np.asarray(Image.open(path).convert(
            "RGB" if arr.ndim == 3 else Image.open(path).mode))
        if name == "depth":
            want = want.astype(np.uint16)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(TI.read_image(path),
                                      JI.read_image(path), err_msg=name)
    batch = native.read_png_batch([tmp_path / "rgb.png"] * 3, n_threads=2)
    np.testing.assert_array_equal(batch, np.stack([imgs["rgb"]] * 3))
    depth_m = rng.uniform(0.2, 3.0, (24, 32)).astype(np.float32)
    JI.write_depth_png(tmp_path / "dj.png", depth_m)
    TI.write_depth_png(tmp_path / "dt.png", depth_m)
    assert (tmp_path / "dt.png").read_bytes() == \
        (tmp_path / "dj.png").read_bytes()
    np.testing.assert_array_equal(TI.read_depth_png(tmp_path / "dt.png"),
                                  JI.read_depth_png(tmp_path / "dj.png"))
    np.testing.assert_array_equal(TI.rgb_to_gray(imgs["rgb"]),
                                  JI.rgb_to_gray(imgs["rgb"]))
    np.testing.assert_array_equal(TI.rgb_to_bgr(imgs["rgb"]),
                                  JI.rgb_to_bgr(imgs["rgb"]))


def _png_with_filters(arr: np.ndarray) -> bytes:
    """A PNG of arr (8-bit gray/RGB/RGBA or 16-bit gray) whose row y uses
    filter type y % 5, so every filter is exercised."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    bits = 16 if arr.dtype == np.uint16 else 8
    raw = (arr.astype(">u2") if bits == 16 else arr).tobytes()
    stride = w * c * bits // 8
    bpp = c * bits // 8
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = y % 5
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb", "gray", "gray_alpha", "rgba",
                                  "depth"])
def test_png_filters_native_codec_matches_pil(tmp_path, kind):
    from PIL import Image

    rng = np.random.default_rng(7)
    shape = {"rgb": (23, 17, 3), "gray": (11, 29), "gray_alpha": (9, 8, 2),
             "rgba": (12, 10, 4), "depth": (15, 21)}[kind]
    arr = rng.integers(0, 65536 if kind == "depth" else 256, shape).astype(
        np.uint16 if kind == "depth" else np.uint8)
    path = tmp_path / f"{kind}.png"
    path.write_bytes(_png_with_filters(arr))
    im = Image.open(path)
    want = np.asarray(im.convert("RGB") if kind in ("rgba",) else im)
    if kind == "gray_alpha":
        want = want[..., 0]
    want = want.astype(arr.dtype)
    np.testing.assert_array_equal(want, arr[..., :3] if kind == "rgba" else
                                  arr[..., 0] if kind == "gray_alpha" else arr)
    assert native.available(), native.build_error
    got = native.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_read_image_without_codec_or_pil_raises(tmp_path, monkeypatch):
    import sys

    from PIL import Image

    Image.fromarray(np.zeros((4, 4), np.uint8)).save(tmp_path / "z.png")
    monkeypatch.setattr(native, "read_png", lambda path: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="native codec.*PIL"):
        TI.read_image(tmp_path / "z.png")
