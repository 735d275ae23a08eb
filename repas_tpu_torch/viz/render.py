"""Device-side point-cloud splat renderer.

Port of ``repas_tpu/viz/render.py`` (``render_pointcloud``, ``look_at``,
``orbit_views``, ``rasterize_segments``) on tensors, on the device of
the points (or of the image being drawn on).

The reference renders point clouds with a CPU software rasterizer —
project / view transform / grid / frustum culling / painter's-sort point
splatting (capture_aligned_all.py:127-186, AppState view controls :26-53).
The port keeps the reference's two-pass z-buffer:

  view transform -> pinhole project -> scatter-min depth per pixel ->
  the point that owns its pixel's depth writes its colour

Two things differ in how the scatters are written, neither in what they
compute:
- Dropped writes. The reference drops out-of-frame and losing points
  with negative indices and ``mode="drop"``; a negative index in torch
  wraps, so the port scatters them as the reduction's identity (+inf
  into the depth minimum, -1 into the winner maximum), which changes no
  pixel, at pixels spread over the image (one shared dump address
  would serialise the card's atomics: 84 ms for 1M points on an
  H100).
- Tied winners. Several points can pass ``z <= zbuf * (1 + 1e-6)`` at
  one pixel, and a scatter's order among duplicates is undefined. XLA's
  CPU scatter applies updates in sequence, so the reference's image
  shows, per pixel, the last splat offset's highest point index. The
  port picks exactly that point, on every device, with one ``amax``
  scatter of the int32 key ``offset_index * N + point_index`` and one
  gather of its colour, so the card's image is deterministic too.

``render_pointcloud`` is a compiled step (``core.jit``: on the card one
CUDA graph per point count, ``shape`` and ``splat``). ``background`` and
``z_near`` are 0-d tensors in it, and a numpy camera (``K``, ``R``,
``t``) is copied to the points' device before the step, so every view
replays the same graph with its own camera.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.kernels.image import _fma


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                           else x, device=device).to(torch.float32)


def _project(pts: torch.Tensor, K, R, t):
    """World points (N,3) in the camera (R, t): (camera z (N,), camera
    points (N,3), K as a float32 tensor on their device)."""
    dev = pts.device
    R, t = _as_f32(R, dev), _as_f32(t, dev)
    # XLA's CPU dot: fma(p2, R2, fma(p1, R1, p0 R0)) per row (probed equal
    # on 200,000 points), then + t; written out so that the card rounds
    # as the CPU does (cuBLAS promises no order)
    rows = []
    for j in range(3):
        a = pts[:, 0] * R[j, 0]
        a = _fma(pts[:, 1], R[j, 1].expand_as(a), a)
        a = _fma(pts[:, 2], R[j, 2].expand_as(a), a)
        rows.append(a + t[j])
    cam = torch.stack(rows, dim=1)
    return cam[:, 2], cam, _as_f32(K, dev)


def _pixels(cam: torch.Tensor, K: torch.Tensor, z: torch.Tensor,
            z_near: float):
    """(in front of z_near (N,), u (N,), v (N,) int64 truncated pixel
    coordinates)."""
    valid = z > z_near
    zs = torch.where(valid, z, 1.0)
    # truncation toward zero, as the reference's astype(int32)
    u = (K[0, 0] * cam[:, 0] / zs + K[0, 2]).to(torch.int32).to(torch.int64)
    v = (K[1, 1] * cam[:, 1] / zs + K[1, 2]).to(torch.int32).to(torch.int64)
    return valid, u, v


def _offsets(splat: int):
    return [(dv, du) for dv in range(splat) for du in range(splat)]


def _slots(valid, u, v, du: int, dv: int, H: int, W: int):
    """Flat pixel index of each point's (du, dv) splat pixel and whether
    it lands in the frame; a point that does not gets a pixel of its own
    spread over the image (point index mod H*W), where it scatters the
    reduction's identity."""
    uu, vv = u + du, v + dv
    ok = valid & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
    spread = torch.arange(u.shape[0], device=u.device) % (H * W)
    return torch.where(ok, vv * W + uu, spread), ok


def zbuffer(xyzrgb: torch.Tensor, K, R, t, shape: tuple = (720, 1280),
            splat: int = 2, z_near: float = 1e-3) -> torch.Tensor:
    """Pass 1 of ``render_pointcloud`` alone: the (H,W) float32 nearest
    camera depth per pixel (+inf where no splat lands)."""
    H, W = shape
    z, cam, Kt = _project(xyzrgb[:, :3].to(torch.float32), K, R, t)
    valid, u, v = _pixels(cam, Kt, z, z_near)
    return _zbuf(z, valid, u, v, H, W, splat).reshape(H, W)


def _zbuf(z, valid, u, v, H, W, splat):
    """The (H*W,) scatter-min depth. A depth in front of z_near is a
    positive float, whose bits order as int32s do, so the minimum is
    taken on the bits: an int32 atomic on the card (a float atomicMin is
    a compare-and-swap loop there)."""
    inf_bits = torch.tensor(float("inf")).view(torch.int32).item()
    zbuf = torch.full((H * W,), inf_bits, dtype=torch.int32,
                      device=z.device)
    z_bits = z.view(torch.int32)
    for dv, du in _offsets(splat):
        idx, ok = _slots(valid, u, v, du, dv, H, W)
        zbuf.scatter_reduce_(0, idx, torch.where(ok, z_bits, inf_bits),
                             "amin")
    return zbuf.view(torch.float32)


def _last_writer(keys: torch.Tensor, idx: torch.Tensor, n_pix: int
                 ) -> torch.Tensor:
    """Per flat pixel the largest int32 key scattered to it, -1 where
    none (a dropped write scatters -1)."""
    best = torch.full((n_pix,), -1, dtype=torch.int32, device=idx.device)
    return best.scatter_reduce_(0, idx, keys, "amax")


@functools.partial(jit, static_argnames=("shape", "splat"),
                   scalar_argnames=("background", "z_near"),
                   array_argnames=("K", "R", "t"))
def render_pointcloud(xyzrgb: torch.Tensor, K, R, t,
                      shape: tuple = (720, 1280), splat: int = 2,
                      background: float = 1.0,
                      z_near: float = 1e-3) -> torch.Tensor:
    """Render (N,6) xyzrgb points seen from camera (R, t): x_cam = R x + t.

    Colors in [0,1] (uint8-range inputs are scaled). Returns (H,W,3)
    float32 on the points' device. `splat` is the square splat side in
    pixels (2 fills typical RGB-D cloud density at capture resolution).
    Where several points tie for a pixel's depth, the one the reference's
    CPU scatter leaves there wins: the last splat offset's highest point
    index.
    """
    H, W = shape
    xyzrgb = xyzrgb.to(torch.float32)
    n = xyzrgb.shape[0]
    rgb = xyzrgb[:, 3:6]
    # the reference's rgb / 255.0 is a multiply by the f32 reciprocal
    # under jit
    rgb = torch.where(torch.amax(rgb) > 1.5, rgb * np.float32(1.0 / 255.0),
                      rgb)
    z, cam, Kt = _project(xyzrgb[:, :3], K, R, t)
    valid, u, v = _pixels(cam, Kt, z, z_near)
    zbuf = _zbuf(z, valid, u, v, H, W, splat)

    if splat * splat * n >= 2 ** 31:
        raise ValueError(f"{n} points x {splat}^2 splat offsets overflow "
                         "the int32 winner keys")
    pt = torch.arange(n, dtype=torch.int32, device=xyzrgb.device)
    keys, slots = [], []
    for k, (dv, du) in enumerate(_offsets(splat)):
        idx, ok = _slots(valid, u, v, du, dv, H, W)
        win = ok & (z <= zbuf[idx] * (1 + 1e-6))
        slots.append(idx)
        keys.append(torch.where(win, k * n + pt, -1))
    best = _last_writer(torch.cat(keys), torch.cat(slots), H * W)
    img = torch.where((best >= 0)[:, None],
                      rgb[(torch.clamp(best, min=0) % n).long()],
                      background)
    return img.reshape(H, W, 3)


def look_at(eye, center, up=(0.0, 1.0, 0.0)):
    """Camera (R, t) looking from `eye` at `center` (OpenCV convention:
    +z forward, +y down). Returns (R (3,3), t (3,)) float32 numpy, as the
    reference (host numpy, copied)."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    fwd = center - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-9:
        right = np.cross(fwd, np.array([1.0, 0, 0]))
    right = right / max(np.linalg.norm(right), 1e-12)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def orbit_views(center, radius: float, n: int = 8, elev_deg: float = 25.0):
    """n camera poses orbiting `center` (the view_pointcloud orbit set)."""
    out = []
    el = np.radians(elev_deg)
    for i in range(n):
        az = 2 * np.pi * i / n
        eye = np.asarray(center) + radius * np.array([
            np.cos(el) * np.sin(az), -np.sin(el), -np.cos(el) * np.cos(az)])
        out.append(look_at(eye, center))
    return out


def rasterize_segments(img: torch.Tensor, segs, colors, K, R, t,
                       samples: int = 256) -> torch.Tensor:
    """Overlay 3-D line segments (grid/axes/frustum wireframes from
    viz.scene) by sampling each segment and splatting — the device-side
    version of the reference's grid/axes overlay
    (capture_aligned_all.py:147-170). Returns a new image on img's
    device; where samples overlap, the last one (highest index) wins, as
    in the reference's CPU scatter.

    img (H,W,3) float32, segs (S,2,3) endpoints, colors (S,3)."""
    dev = img.device
    segs = _as_f32(segs, dev)
    colors = _as_f32(colors, dev)
    ts = _linspace01(samples, dev)[None, :, None]
    pts = segs[:, None, 0, :] * (1 - ts) + segs[:, None, 1, :] * ts
    pts = pts.reshape(-1, 3)
    col = torch.repeat_interleave(colors, samples, dim=0)
    H, W = img.shape[:2]
    z, cam, Kt = _project(pts, K, R, t)
    ok, u, v = _pixels(cam, Kt, z, 1e-3)
    idx, ok = _slots(ok, u, v, 0, 0, H, W)
    keys = torch.arange(len(pts), dtype=torch.int32, device=dev)
    best = _last_writer(torch.where(ok, keys, -1), idx, H * W)
    flat = img.reshape(H * W, 3)
    out = torch.where((best >= 0)[:, None],
                      col[torch.clamp(best, min=0).long()], flat)
    return out.reshape(img.shape)


def _linspace01(samples: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, samples) as the reference computes it: jitted,
    iota / (samples - 1) becomes iota times the f32 reciprocal, then the
    endpoint 1 (probed equal at 2-4,096 samples; torch.linspace and
    numpy's linspace rounded to f32 each differ in up to half the
    entries)."""
    if samples < 2:
        return torch.zeros(samples, dtype=torch.float32, device=device)
    div = samples - 1
    io = torch.arange(div, dtype=torch.float32, device=device)
    return torch.cat([io * np.float32(1.0 / div),
                      torch.ones(1, dtype=torch.float32, device=device)])
