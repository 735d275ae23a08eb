"""Seeded RGB-D scenes of tag36h11 tags, rendered on the card.

A frozen copy, in plain torch, of the port's synthetic tag renderer
(``repas_tpu_torch/detect/render.py``: ``tag_grid``,
``_undistort_normalized_np``, ``render_tag_in_scene``, the frame of
``example_frame``) and of the bench's frame makers
(``repas_tpu_torch/bench.py``: ``_frames``' integer noise in [-8, 8),
``robust_frames``' posed tags of 61-87 px on a 180 gray background). It
imports nothing of the program: the benchmark makes its inputs itself,
and later changes to the program cannot change them.

What it adds to the copies: several posed tags a frame (tag 16, the
anchor, in every frame), a depth map drawn from the same geometry (each
tag's card plane in front of a tilted background plane, u16 millimetres
with seeded dropouts), a gentle background gradient, and the truth each
frame was rendered from (ids, rotations, translations), which the
reference in ``benchmark/reference/frames.py`` judges the detections by.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# tag36h11 codewords 0-23 (the family's canonical rotations), frozen from
# the port's codebook; bit 35 is the top-left data cell, 1 is white
TAG36H11_CODES = (
    0xD5D628584, 0xD97F18B49, 0xDD280910E, 0xE479E9C98, 0xEBCBCA822,
    0xF31DAB3AC, 0x056A5D085, 0x10652E1D4, 0x22B1DFEAD, 0x265AD0472,
    0x34FE91B86, 0x3FF962CD5, 0x43A25329A, 0x474B4385F, 0x4E9D243E9,
    0x5246149AE, 0x5997F5538, 0x683BB6C4C, 0x6BE4A7211, 0x7E3158EEA,
    0x81DA494AF, 0x858339A74, 0x8CD51A5FE, 0x9F21CC2D7)
CELLS = 8          # black border + 6x6 data
MARGIN_CELLS = 2   # white quiet zone around the tag, in cells
WHITE, BLACK = 220.0, 30.0
CARD_SPAN = (CELLS + 2 * MARGIN_CELLS) / CELLS   # card side / tag side


def tag_grid(tag_id: int) -> np.ndarray:
    """(8,8) float grid of a tag: 1 white, 0 black, border included."""
    code = TAG36H11_CODES[tag_id]
    bits = [(code >> (35 - i)) & 1 for i in range(36)]
    g = np.zeros((CELLS, CELLS), np.float32)
    g[1:-1, 1:-1] = np.array(bits, np.float32).reshape(6, 6)
    return g


@dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics and an optional Brown-Conrady lens
    (k1, k2, p1, p2, k3[, k4, k5, k6]); `dist` None is a camera without
    one."""
    width: int
    height: int
    K: np.ndarray              # (3,3) float64
    dist: np.ndarray | None    # (8,) float64 or None

    @classmethod
    def from_config(cls, cfg: dict) -> "Camera":
        cam = cfg["camera"]
        K = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                      [0.0, 0.0, 1.0]])
        dist = cam.get("dist")
        if dist is not None:
            dist = np.array(list(dist) + [0.0] * (8 - len(dist)), np.float64)
        return cls(cam["width"], cam["height"], K, dist)


def distort(x, y, dist):
    """The 8-coefficient rational Brown-Conrady model on normalized
    coordinates (numpy or torch, any float type)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = (float(c) for c in dist)
    r2 = x * x + y * y
    radial = ((1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
              / (1 + r2 * (k4 + r2 * (k5 + r2 * k6))))
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def undistort(xd, yd, dist, iters: int = 25):
    """Inverts ``distort`` by fixed-point steps (render.py's
    ``_undistort_normalized_np``)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = (float(c) for c in dist)
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = ((1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
                  / (1 + r2 * (k4 + r2 * (k5 + r2 * k6))))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def axis_angle(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    S = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * S + (1 - math.cos(angle)) * S @ S


@dataclass
class Frame:
    """One frame's truth: tag ids, rotations (3,3) and translations (3,)
    of each tag's frame (x right, y down, z into the card, origin at the
    tag's centre), and the background plane n . X = d."""
    ids: list
    R: list
    t: list
    bg_n: np.ndarray
    bg_d: float


def draw_frames(rng: np.random.Generator, cam: Camera, traffic: dict,
                tag_size: float, anchor_id: int, n_frames: int) -> list:
    """The truth of `n_frames` frames. Every batch of
    len(traffic["tags_per_frame"]) frames holds each count of that list
    once, in a seeded order, so every seed renders the same number of
    tags; sizes, tilts (up to ``tilt_max_deg``), in-plane turns (either
    way up to the ``roll_max_deg`` of the smallest size bound at or above
    the tag's side), places and ids are seeded. The
    anchor is in every frame; the other ids are drawn without repeats
    from traffic["other_ids"]."""
    counts = list(traffic["tags_per_frame"])
    s_lo, s_hi = traffic["tag_side_px"]
    tilt_max = math.radians(traffic["tilt_max_deg"])
    # [[largest side in px, largest in-plane turn in degrees], ...]
    roll_limits = sorted(traffic["roll_max_deg"])
    w, h = cam.width, cam.height
    fx, fy, cx, cy = cam.K[0, 0], cam.K[1, 1], cam.K[0, 2], cam.K[1, 2]
    frames = []
    order = []
    while len(order) < n_frames:
        order += list(rng.permutation(counts))
    for n in order[:n_frames]:
        if n == 1:
            cells = [(0, 0, w, h)]
        elif n == 2:
            cells = [(0, 0, w // 2, h), (w // 2, 0, w - w // 2, h)]
        else:
            q = [(0, 0, w // 2, h // 2), (w // 2, 0, w - w // 2, h // 2),
                 (0, h // 2, w // 2, h - h // 2),
                 (w // 2, h // 2, w - w // 2, h - h // 2)]
            cells = [q[i] for i in sorted(rng.permutation(4)[:n])]
        others = list(rng.permutation(traffic["other_ids"])[:n - 1])
        ids = [anchor_id] + [int(i) for i in others]
        ids = [ids[i] for i in rng.permutation(n)]
        Rs, ts = [], []
        for (x0, y0, cw, ch) in cells:
            # the card, turned in plane and tilted, spans at most
            # CARD_SPAN * sqrt(2) tag sides plus a margin
            cap = (min(cw, ch) - 16) / (CARD_SPAN * math.sqrt(2) * 1.1)
            if cap < s_lo:
                raise ValueError(f"{n} tags of {s_lo} px or more do not fit "
                                 f"a {w}x{h} frame")
            side = rng.uniform(s_lo, min(s_hi, cap))
            z = fx * tag_size / side
            half_span = CARD_SPAN * math.sqrt(2) * 1.1 * side / 2
            u = rng.uniform(x0 + half_span + 8, x0 + cw - half_span - 8)
            v = rng.uniform(y0 + half_span + 8, y0 + ch - half_span - 8)
            t = z * np.array([(u - cx) / fx, (v - cy) / fy, 1.0])
            phi = rng.uniform(0, 2 * math.pi)
            R = (axis_angle((math.cos(phi), math.sin(phi), 0.0),
                            rng.uniform(0, tilt_max))
                 @ axis_angle((0, 0, 1), math.radians(rng.uniform(-1, 1) * next(
                     r for s, r in roll_limits if side <= s))))
            Rs.append(R)
            ts.append(t)
        phi = rng.uniform(0, 2 * math.pi)
        bg_n = axis_angle((math.cos(phi), math.sin(phi), 0.0),
                          math.radians(rng.uniform(0, 10)))[:, 2]
        bg_d = rng.uniform(*traffic["background_z_m"]) * bg_n[2]
        frames.append(Frame(ids, Rs, ts, bg_n, float(bg_d)))
    return frames


def render(frames: list, cam: Camera, tag_size: float,
           gen: torch.Generator, device, supersample: int = 2,
           dropout: float = 0.005):
    """(rgb (F,H,W,3) uint8, depth (F,H,W) uint16 mm) of `frames` on
    `device`: render_tag_in_scene's inverse homography per tag at
    `supersample` x `supersample` samples a pixel, each card in front of
    the background; noise in [-8, 8) per channel and depth dropouts from
    `gen` (a generator on `device`)."""
    h, w, ss = cam.height, cam.width, supersample
    K = torch.tensor(cam.K, dtype=torch.float64, device=device)
    f64 = dict(dtype=torch.float64, device=device)

    def rays(hh, ww, step):
        ys = (torch.arange(hh, **f64) + 0.5) * step - 0.5
        xs = (torch.arange(ww, **f64) + 0.5) * step - 0.5
        xn = ((xs - K[0, 2]) / K[0, 0])[None, :].expand(hh, ww)
        yn = ((ys - K[1, 2]) / K[1, 1])[:, None].expand(hh, ww)
        if cam.dist is not None:
            xn, yn = undistort(xn, yn, cam.dist)
        return xn, yn

    fine = rays(h * ss, w * ss, 1.0 / ss)
    coarse = rays(h, w, 1.0)
    grids = {}
    rgbs = torch.empty((len(frames), h, w, 3), dtype=torch.uint8,
                       device=device)
    depths = torch.empty((len(frames), h, w), dtype=torch.uint16,
                         device=device)
    yy, xx = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64),
                            indexing="ij")
    for k, fr in enumerate(frames):
        xn, yn = fine
        gray = torch.full(xn.shape, 0.0, **f64)
        xc, yc = coarse
        bg_n = torch.tensor(fr.bg_n, **f64)
        zbuf = fr.bg_d / (bg_n[0] * xc + bg_n[1] * yc + bg_n[2])
        for tid, R, t in zip(fr.ids, fr.R, fr.t):
            if tid not in grids:
                grids[tid] = torch.tensor(tag_grid(tid), **f64)
            R_ = torch.tensor(R, **f64)
            t_ = torch.tensor(t, **f64)
            A = torch.stack([R_[:, 0], R_[:, 1], t_], dim=1)
            Ainv = torch.linalg.inv(A)
            half = tag_size / 2
            card_half = half * CARD_SPAN

            def plane(xn_, yn_):
                p = (Ainv[:, 0, None, None] * xn_ + Ainv[:, 1, None, None] * yn_
                     + Ainv[:, 2, None, None])
                front = p[2] > 0
                return p[0] / p[2], p[1] / p[2], front

            tx, ty, front = plane(xn, yn)
            in_card = front & (tx.abs() <= card_half) & (ty.abs() <= card_half)
            in_tag = front & (tx.abs() <= half) & (ty.abs() <= half)
            cxi = torch.clamp(((tx + half) * (CELLS / tag_size)).floor(), 0,
                              CELLS - 1).long()
            cyi = torch.clamp(((ty + half) * (CELLS / tag_size)).floor(), 0,
                              CELLS - 1).long()
            val = BLACK + (WHITE - BLACK) * grids[tid][cyi, cxi]
            gray = torch.where(in_card, torch.where(in_tag, val, WHITE), gray)
            # the card's depth at the pixel centres, where it covers them
            n = R_[:, 2]
            tx_c, ty_c, front_c = plane(xc, yc)
            card_c = (front_c & (tx_c.abs() <= card_half)
                      & (ty_c.abs() <= card_half))
            zc = (n @ t_) / (n[0] * xc + n[1] * yc + n[2])
            zbuf = torch.where(card_c & (zc < zbuf), zc, zbuf)
        # the background (0 where a card covers the sample): a gentle
        # gradient around the bench frame's 180
        bg = (180.0 + 18.0 * torch.sin(xx / 211.0 + k) * torch.cos(yy / 157.0))
        g = gray.reshape(h, ss, w, ss).mean(dim=(1, 3))
        cover = (gray > 0).to(torch.float64).reshape(h, ss, w, ss).mean(
            dim=(1, 3))
        g = g + (1.0 - cover) * bg
        noise = torch.randint(-8, 8, (h, w, 3), generator=gen, device=device)
        rgbs[k] = torch.clamp(g[..., None].round() + noise, 0, 255).to(
            torch.uint8)
        holes = torch.rand((h, w), generator=gen, device=device) < dropout
        mm = torch.clamp((zbuf * 1000.0).round(), 0, 65535)
        depths[k] = torch.where(holes, 0.0, mm).to(torch.int32).to(
            torch.uint16)
    return rgbs, depths


def truth_corners(fr: Frame, cam: Camera, tag_size: float) -> np.ndarray:
    """(n,4,2) float64 pixel corners of each tag of `fr`, in the object
    order TL, TR, BR, BL of the tag frame: (-h,-h), (h,-h), (h,h), (-h,h)."""
    h = tag_size / 2
    obj = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]])
    out = []
    for R, t in zip(fr.R, fr.t):
        X = obj @ R.T + t
        x, y = X[:, 0] / X[:, 2], X[:, 1] / X[:, 2]
        if cam.dist is not None:
            x, y = distort(x, y, cam.dist)
        out.append(np.stack([cam.K[0, 0] * x + cam.K[0, 2],
                             cam.K[1, 1] * y + cam.K[1, 2]], -1))
    return np.array(out)
