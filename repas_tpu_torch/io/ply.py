"""PLY / STL geometry I/O — self-contained replacement for the Open3D

Port of ``repas_tpu/io/ply.py`` (host numpy, unchanged: the writers
emit the same bytes, the reference's "repas_tpu" comment and STL header
included, so a file chain can mix both packages).
read/write call sites (load_cad_geometry final_view_with_cad.py:144-152,
save_point_cloud_to_ply better_three_capture.py:39, ply_to_stl.py:10-37).

Supports:
  * PLY ascii + binary_little_endian, point clouds and triangle meshes,
    per-vertex xyz / normals / rgb(a) colors
  * STL binary + ascii triangle meshes

Geometry containers are plain numpy (host-side); device code consumes the
raw arrays.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int",
            "u4": "uint", "u2": "ushort"}


@dataclass
class PointCloud:
    points: np.ndarray                      # (N,3) float
    colors: Optional[np.ndarray] = None     # (N,3) float in [0,1]
    normals: Optional[np.ndarray] = None    # (N,3) float

    def __len__(self):
        return len(self.points)

    def select(self, idx) -> "PointCloud":
        return PointCloud(
            points=self.points[idx],
            colors=None if self.colors is None else self.colors[idx],
            normals=None if self.normals is None else self.normals[idx],
        )

    def transformed(self, T: np.ndarray) -> "PointCloud":
        T = np.asarray(T)
        pts = self.points @ T[:3, :3].T + T[:3, 3]
        nrm = None
        if self.normals is not None:
            R = T[:3, :3]
            # transform normals with R only (assumes similarity transform)
            s = np.cbrt(abs(np.linalg.det(R))) or 1.0
            nrm = self.normals @ (R / s).T
        return PointCloud(points=pts, colors=self.colors, normals=nrm)

    def get_center(self) -> np.ndarray:
        return self.points.mean(axis=0)

    def aabb(self):
        return self.points.min(axis=0), self.points.max(axis=0)


@dataclass
class TriangleMesh:
    vertices: np.ndarray                    # (V,3)
    triangles: np.ndarray                   # (F,3) int
    vertex_colors: Optional[np.ndarray] = None
    vertex_normals: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.vertices)

    def get_center(self) -> np.ndarray:
        return self.vertices.mean(axis=0)

    def transformed(self, T: np.ndarray) -> "TriangleMesh":
        T = np.asarray(T)
        v = self.vertices @ T[:3, :3].T + T[:3, 3]
        return TriangleMesh(vertices=v, triangles=self.triangles,
                            vertex_colors=self.vertex_colors,
                            vertex_normals=self.vertex_normals)

    def compute_vertex_normals(self) -> np.ndarray:
        v, f = self.vertices, self.triangles
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for i in range(3):
            np.add.at(vn, f[:, i], fn)
        n = np.linalg.norm(vn, axis=1, keepdims=True)
        vn = vn / np.maximum(n, 1e-12)
        self.vertex_normals = vn
        return vn

    def sample_points_uniformly(self, n: int, seed: int = 0) -> PointCloud:
        """Area-weighted uniform surface sampling
        (Open3D sample_points_uniformly equivalent, mpa_icp_export.py:168-172)."""
        rng = np.random.default_rng(seed)
        v, f = self.vertices, self.triangles
        a = v[f[:, 0]]
        e1 = v[f[:, 1]] - a
        e2 = v[f[:, 2]] - a
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        p = area / max(area.sum(), 1e-30)
        tri = rng.choice(len(f), size=n, p=p)
        r1 = np.sqrt(rng.random(n))
        r2 = rng.random(n)
        # P = A + sqrt(r1)(1-r2) (B-A) + sqrt(r1) r2 (C-A) is uniform on the tri
        pts = a[tri] + (r1 * (1 - r2))[:, None] * e1[tri] + (r1 * r2)[:, None] * e2[tri]
        return PointCloud(points=pts)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def read_ply(path):
    """Read a PLY file -> PointCloud or TriangleMesh."""
    data = Path(path).read_bytes()
    if not data.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    # parse header
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype, is_list, list_len_dtype)])
    for line in header[1:]:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_DTYPES[parts[3]], True,
                                        _PLY_DTYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]], False, None))

    out = {}
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if any(p[2] for p in props):
                faces = []
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    faces.append([int(tokens[pos + i]) for i in range(n)])
                    pos += n
                out[name] = {"vertex_indices": np.asarray(faces)}
            else:
                k = len(props)
                arr = np.array(tokens[pos:pos + count * k], dtype=np.float64)
                arr = arr.reshape(count, k)
                pos += count * k
                out[name] = {p[0]: arr[:, i] for i, p in enumerate(props)}
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if any(p[2] for p in props):
                # assume uniform triangle lists (standard for meshes)
                faces = []
                lname, ldt, _, llen = props[0]
                lsz = np.dtype(llen).itemsize
                isz = np.dtype(ldt).itemsize
                for _ in range(count):
                    n = int(np.frombuffer(body, dtype=llen, count=1, offset=off)[0])
                    off += lsz
                    faces.append(np.frombuffer(body, dtype="<" + ldt, count=n,
                                               offset=off))
                    off += n * isz
                out[name] = {"vertex_indices": np.asarray(faces)}
            else:
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                out[name] = {p[0]: arr[p[0]] for p in props}
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    v = out.get("vertex", {})
    pts = np.stack([np.asarray(v[k], dtype=np.float64) for k in ("x", "y", "z")],
                   axis=1)
    colors = None
    if "red" in v:
        colors = np.stack([np.asarray(v[k], dtype=np.float64)
                           for k in ("red", "green", "blue")], axis=1)
        if colors.max() > 1.0:
            colors = colors / 255.0
    normals = None
    if "nx" in v:
        normals = np.stack([np.asarray(v[k], dtype=np.float64)
                            for k in ("nx", "ny", "nz")], axis=1)
    if "face" in out and len(out["face"]["vertex_indices"]) > 0:
        return TriangleMesh(vertices=pts,
                            triangles=np.asarray(out["face"]["vertex_indices"],
                                                 dtype=np.int64),
                            vertex_colors=colors, vertex_normals=normals)
    return PointCloud(points=pts, colors=colors, normals=normals)


def write_ply(path, geom, ascii: bool = False) -> None:
    """Write a PointCloud or TriangleMesh as PLY."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    is_mesh = isinstance(geom, TriangleMesh)
    pts = np.asarray(geom.vertices if is_mesh else geom.points, dtype=np.float64)
    colors = geom.vertex_colors if is_mesh else geom.colors
    normals = geom.vertex_normals if is_mesh else geom.normals

    props = [("x", "f8"), ("y", "f8"), ("z", "f8")]
    if normals is not None:
        props += [("nx", "f8"), ("ny", "f8"), ("nz", "f8")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]

    header = ["ply",
              "format ascii 1.0" if ascii else "format binary_little_endian 1.0",
              "comment generated by repas_tpu",
              f"element vertex {len(pts)}"]
    for name, dt in props:
        header.append(f"property {_INV_PLY[dt]} {name}")
    if is_mesh:
        header.append(f"element face {len(geom.triangles)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    cols = [pts[:, 0], pts[:, 1], pts[:, 2]]
    if normals is not None:
        cols += [normals[:, 0], normals[:, 1], normals[:, 2]]
    if colors is not None:
        c = np.asarray(colors)
        if c.max() <= 1.0 + 1e-9:
            c = np.clip(np.round(c * 255.0), 0, 255)
        cols += [c[:, 0], c[:, 1], c[:, 2]]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii:
            fmtparts = []
            for (_, dt) in props:
                fmtparts.append("%d" if dt == "u1" else "%.8g")
            rows = np.stack([np.asarray(c, dtype=np.float64) for c in cols], axis=1)
            np.savetxt(f, rows, fmt=" ".join(fmtparts))
            if is_mesh:
                tri = np.asarray(geom.triangles, dtype=np.int64)
                np.savetxt(f, np.hstack([np.full((len(tri), 1), 3), tri]),
                           fmt="%d")
        else:
            rec = np.zeros(len(pts), dtype=np.dtype([(n, "<" + d) for n, d in props]))
            for (name, _), c in zip(props, cols):
                rec[name] = c
            f.write(rec.tobytes())
            if is_mesh:
                tri = np.asarray(geom.triangles, dtype=np.int32)
                face = np.zeros(len(tri), dtype=np.dtype([("n", "u1"),
                                                          ("v", "<i4", (3,))]))
                face["n"] = 3
                face["v"] = tri
                f.write(face.tobytes())


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------

def read_stl(path) -> TriangleMesh:
    data = Path(path).read_bytes()
    if data[:5].lower() == b"solid" and b"facet" in data[:500]:
        return _read_stl_ascii(data)
    n = struct.unpack("<I", data[80:84])[0]
    rec = np.frombuffer(data, dtype=np.dtype([
        ("normal", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")]),
        count=n, offset=84)
    tris = rec["v"].reshape(-1, 3).astype(np.float64)
    verts, inv = np.unique(tris.round(decimals=9), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    return TriangleMesh(vertices=verts, triangles=faces.astype(np.int64))


def _read_stl_ascii(data: bytes) -> TriangleMesh:
    verts = []
    for line in data.decode("ascii", errors="replace").splitlines():
        parts = line.strip().split()
        if parts[:1] == ["vertex"]:
            verts.append([float(x) for x in parts[1:4]])
    tris = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    uverts, inv = np.unique(tris.round(decimals=9), axis=0, return_inverse=True)
    return TriangleMesh(vertices=uverts,
                        triangles=inv.reshape(-1, 3).astype(np.int64))


def write_stl(path, mesh: TriangleMesh) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    v = np.asarray(mesh.vertices, dtype=np.float32)
    f = np.asarray(mesh.triangles, dtype=np.int64)
    tri = v[f]  # (F,3,3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-30)
    rec = np.zeros(len(f), dtype=np.dtype([
        ("normal", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")]))
    rec["normal"] = n
    rec["v"] = tri
    with open(path, "wb") as out:
        out.write(b"repas_tpu binary STL".ljust(80, b" "))
        out.write(struct.pack("<I", len(f)))
        out.write(rec.tobytes())


def read_geometry(path):
    """Strict mesh/pcd classify + load (ply_to_stl.py:10-37): try mesh,
    fall back to point cloud."""
    p = Path(path)
    if p.suffix.lower() == ".stl":
        return read_stl(p)
    return read_ply(p)
