"""Plain reference for the frame step: numpy in float64, nothing of the
program.

It judges what ``process_frames`` returned for frames the benchmark
rendered itself (``benchmark/scene.py``), stage by stage:

  detector    the valid slots hold exactly the rendered ids, once each
              (``tags_wrong``, a count); of each detected tag, the mean
              distance of its four corners from the rendered tag's
              corners projected through the camera and its lens, and of
              those the largest (``corner_tag_px``): one tag with its
              corners misplaced or in another order reads its own gap,
              not a share of the sample's (a single corner's distance
              swings with the detector's own noise as far as a bfloat16
              control reaches, a tag's four do less).
  pose        each tag's pose (the configured 180-degree flip undone)
              fits the program's own corners as well as their
              reprojection minimum does (Levenberg-Marquardt in float64
              from two starts, the rendered pose and the program's): the
              RMS corner residual over the least one, in pixels
              (``tag_fit_px``). A pose may sit anywhere along the
              directions the four corners leave flat; a wrong branch, a
              missing flip or an altered value does not fit. The
              weighted hemisphere-aligned quaternion average of the
              program's per-tag rotations, weighted by the detector's
              component area over each pose's mean corner residual
              (``fused_R_deg``); the
              anchor slot (``anchor_wrong``, a count) and its
              depth-corrected position: the median of the valid depths in
              a 5x5 window (11x11 where that has none) at the pixel the
              program's anchor translation projects to, deprojected
              (``anchor_mm``).
  cloud       every pixel deprojected, x = (u - cx) z / fx, with its
              colour over 255 where the depth is valid (``cloud_mm``,
              ``color_gap``).

The pose, the fusion and the anchor follow the program's own corners,
rotations and anchor translation (the program's state), which
``corner_tag_px`` and ``tag_fit_px`` judge by themselves. ``control``
puts the reference in the program's place, computed in bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

OBJ_ORDER = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float64)
FLIP = np.array([-1.0, -1.0, 1.0])


def rodrigues(rv: np.ndarray) -> np.ndarray:
    """(...,3) rotation vectors -> (...,3,3)."""
    th = np.linalg.norm(rv, axis=-1)[..., None, None]
    k = rv / np.maximum(th[..., 0], 1e-300)
    K = np.zeros(rv.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def rotvec(R: np.ndarray) -> np.ndarray:
    """(...,3,3) -> (...,3) rotation vectors, through quaternions."""
    q = quat(R)
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    s = np.linalg.norm(q[..., 1:], axis=-1)
    ang = 2 * np.arctan2(s, q[..., 0])
    return q[..., 1:] * (ang / np.maximum(s, 1e-300))[..., None]


def quat(R: np.ndarray) -> np.ndarray:
    """(...,3,3) -> (...,4) unit quaternions (w, x, y, z), Shepperd's
    branch by the largest diagonal term."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cand = np.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
    k = np.argmax(cand, -1)
    q = np.zeros(R.shape[:-2] + (4,))
    for b in range(4):
        sel = k == b
        if not sel.any():
            continue
        M = m[sel]
        if b == 0:
            ww = np.sqrt(1 + M[:, 0, 0] + M[:, 1, 1] + M[:, 2, 2]) / 2
            qq = np.stack([ww, (M[:, 2, 1] - M[:, 1, 2]) / (4 * ww),
                           (M[:, 0, 2] - M[:, 2, 0]) / (4 * ww),
                           (M[:, 1, 0] - M[:, 0, 1]) / (4 * ww)], -1)
        else:
            i = b - 1
            j, l = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(1 + M[:, i, i] - M[:, j, j] - M[:, l, l]) * 2
            qq = np.zeros((len(M), 4))
            qq[:, 0] = (M[:, l, j] - M[:, j, l]) / s
            qq[:, 1 + i] = s / 4
            qq[:, 1 + j] = (M[:, j, i] + M[:, i, j]) / s
            qq[:, 1 + l] = (M[:, l, i] + M[:, i, l]) / s
        q[sel] = qq
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_R(q: np.ndarray) -> np.ndarray:
    w, x, y, z = (q[..., i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angles (degrees) of Ra^T Rb, from the quaternion of the relative
    rotation (accurate for small angles, unlike the trace's arccos)."""
    q = quat(np.swapaxes(Ra, -1, -2) @ Rb)
    return np.degrees(2 * np.arctan2(np.linalg.norm(q[..., 1:], axis=-1),
                                     np.abs(q[..., 0])))


def distort(x, y, dist):
    k1, k2, p1, p2, k3, k4, k5, k6 = dist
    r2 = x * x + y * y
    radial = ((1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
              / (1 + r2 * (k4 + r2 * (k5 + r2 * k6))))
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def project(p: np.ndarray, obj: np.ndarray, K: np.ndarray, dist):
    """(M,6) [rotation vector, t] -> (M,4,2) pixels of the 4 object
    points."""
    X = obj @ np.swapaxes(rodrigues(p[:, :3]), -1, -2) + p[:, None, 3:]
    x, y = X[..., 0] / X[..., 2], X[..., 1] / X[..., 2]
    if dist is not None:
        x, y = distort(x, y, dist)
    return np.stack([K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]], -1)


def polish(p0: np.ndarray, img: np.ndarray, obj: np.ndarray, K: np.ndarray,
           dist, iters: int = 40) -> tuple[np.ndarray, np.ndarray]:
    """Levenberg-Marquardt on the reprojection error of (M,4,2) corners
    from (M,6) starts, central-difference Jacobian, float64. Returns
    (params (M,6), cost (M,))."""
    p = p0.copy()

    def res(q):
        return (project(q, obj, K, dist) - img).reshape(len(q), -1)

    r = res(p)
    cost = (r * r).sum(-1)
    lam = np.full(len(p), 1e-6)
    for _ in range(iters):
        J = np.empty((len(p), r.shape[1], 6))
        for j in range(6):
            h = 1e-7 * np.maximum(np.abs(p[:, j]), 1e-2)
            e = np.zeros(6)
            e[j] = 1.0
            J[:, :, j] = (res(p + h[:, None] * e) - res(p - h[:, None] * e)
                          ) / (2 * h[:, None])
        JTJ = np.swapaxes(J, 1, 2) @ J
        g = (np.swapaxes(J, 1, 2) @ r[..., None])[..., 0]
        A = JTJ + (lam * np.trace(JTJ, axis1=1, axis2=2) / 6)[:, None, None] \
            * np.eye(6)
        step = np.linalg.solve(A, g[..., None])[..., 0]
        pn = p - step
        rn = res(pn)
        cn = (rn * rn).sum(-1)
        ok = cn < cost
        p = np.where(ok[:, None], pn, p)
        r = np.where(ok[:, None], rn, r)
        cost = np.where(ok, cn, cost)
        lam = np.where(ok, np.maximum(lam / 3, 1e-12), np.minimum(lam * 8, 1e6))
    return p, cost


def median_window(depth_m: np.ndarray, u: int, v: int, win: int):
    """Median of the finite positive depths in the win x win window at
    (u, v), clamped to the image by edge replication; the mean of the two
    middle values for an even count; 0 where none."""
    h, w = depth_m.shape
    r = max(1, win // 2)
    uu = np.clip(np.clip(u, 0, w - 1) + np.arange(-r, r + 1), 0, w - 1)
    vv = np.clip(np.clip(v, 0, h - 1) + np.arange(-r, r + 1), 0, h - 1)
    vals = np.sort(depth_m[np.ix_(vv, uu)].ravel())
    vals = vals[np.isfinite(vals) & (vals > 0)]
    n = len(vals)
    if n == 0:
        return 0.0
    return 0.5 * (float(vals[(n - 1) // 2]) + float(vals[n // 2]))


def anchor_position(t: np.ndarray, depth_u16: np.ndarray, K: np.ndarray,
                    scale: float, win: int, fallback_win: int,
                    rnd=np.float32, out=np.float64) -> np.ndarray:
    """The depth-corrected anchor of a translation: the pixel it projects
    to in the arithmetic `rnd` rounds to (the program's float32; round
    half to even), the windowed median of the depths there in meters,
    deprojected in the arithmetic `out` rounds to; the translation itself
    where the pixel is off the image, t_z is not positive or no depth is
    valid."""
    h, w = depth_u16.shape
    fx, fy, cx, cy = (rnd(K[0, 0]), rnd(K[1, 1]), rnd(K[0, 2]),
                      rnd(K[1, 2]))
    tx, ty, tz = (rnd(a) for a in t)
    if not tz > 1e-6:
        return np.asarray(t, np.float64)
    u = int(np.round(rnd(rnd(rnd(fx * tx) / tz) + cx)))
    v = int(np.round(rnd(rnd(rnd(fy * ty) / tz) + cy)))
    depth_m = rnd(rnd(depth_u16.astype(np.float64)) * rnd(scale))
    z = median_window(depth_m, u, v, win)
    if not z > 0:
        z = median_window(depth_m, u, v, fallback_win)
    if not (0 <= u < w and 0 <= v < h and z > 0):
        return np.asarray(t, np.float64)
    z = rnd(z)
    fx, fy, cx, cy = (out(K[0, 0]), out(K[1, 1]), out(K[0, 2]),
                      out(K[1, 2]))
    return np.array([out(out(out(u - cx) / fx) * z),
                     out(out(out(v - cy) / fy) * z), z], np.float64)


def cloud(depth_u16: np.ndarray, rgb: np.ndarray, K: np.ndarray,
          scale: float) -> np.ndarray:
    """(6, H*W) float64 [x, y, z, r, g, b] of one frame."""
    h, w = depth_u16.shape
    z = depth_u16.astype(np.float64) * scale
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    col = rgb.astype(np.float64) / 255.0 * (z > 0)[..., None]
    return np.stack([(u - K[0, 2]) * z / K[0, 0], (v - K[1, 2]) * z / K[1, 1],
                     z, col[..., 0], col[..., 1], col[..., 2]]).reshape(6, -1)


def judge(res: dict, truth: list, cam, pcfg: dict, rgbs=None,
          depths=None, clouds=None) -> dict:
    """Readings of one sample of frames. `res`: the program's outputs as
    numpy arrays with a leading frame axis (ids, valid, corners, areas,
    R, t, R_avg, anchor_idx, anchor_t, anchor_P); `truth`: each frame's
    ``scene.Frame``; `rgbs`/`depths`: each frame's inputs (host arrays);
    `clouds`: {frame index: (6, H*W) program cloud}."""
    from benchmark.scene import truth_corners

    K = cam.K
    dist = None if cam.dist is None else tuple(cam.dist)
    size = pcfg["tag_size_m"]
    obj = OBJ_ORDER * (size / 2)
    flips = set(pcfg["flip_z_ids"])
    out = dict(tags_wrong=0, anchor_wrong=0, corner_tag_px=0.0,
               tag_fit_px=0.0, fused_R_deg=0.0, anchor_mm=0.0)
    gaps = []
    rows = []      # (frame, slot, truth index) of every matched detection
    for f, fr in enumerate(truth):
        valid = np.asarray(res["valid"][f], bool)
        got = [int(i) for i in res["ids"][f][valid]]
        if sorted(got) != sorted(fr.ids):
            out["tags_wrong"] += 1
        slots = np.flatnonzero(valid)
        tc = truth_corners(fr, cam, size)
        for s in slots:
            i = int(res["ids"][f][s])
            if i in fr.ids:
                k = fr.ids.index(i)
                rows.append((f, s, k))
                gaps.append(np.linalg.norm(
                    res["corners"][f][s].astype(np.float64) - tc[k],
                    axis=-1).mean())
    if gaps:
        out["corner_tag_px"] = float(max(gaps))
    if rows:
        F, S, T = (np.array(x) for x in zip(*rows))
        img = res["corners"][F, S].astype(np.float64)
        flip = np.array([int(i) in flips for i in res["ids"][F, S]])
        R_prog = res["R"][F, S].astype(np.float64)
        p_prog = np.concatenate([
            rotvec(np.where(flip[:, None, None], R_prog * FLIP, R_prog)),
            res["t"][F, S].astype(np.float64)], -1)
        d_prog = np.linalg.norm(project(p_prog, obj, K, dist) - img, axis=-1)
        starts = [p_prog, np.stack([
            np.concatenate([rotvec(truth[f].R[k]), truth[f].t[k]])
            for f, k in zip(F, T)])]
        cost = None
        for p0 in starts:
            _, c = polish(p0, img, obj, K, dist)
            cost = c if cost is None else np.minimum(cost, c)
        # the program's pose's RMS corner residual over the least one
        excess = np.sqrt((d_prog ** 2).mean(-1)) - np.sqrt(cost / 4)
        out["tag_fit_px"] = float(excess.max())
        err = d_prog.mean(-1)
        for f in range(len(truth)):
            m = F == f
            if not m.any():
                continue
            w = (np.maximum(res["areas"][f][S[m]].astype(np.float64), 1e-3)
                 / np.maximum(err[m], 1e-3))
            q = quat(R_prog[m])
            q = q * np.where((q * q[0]).sum(-1, keepdims=True) < 0, -1.0, 1.0)
            qa = (w[:, None] * q).sum(0)
            R_avg = quat_to_R(qa / np.linalg.norm(qa))
            out["fused_R_deg"] = max(out["fused_R_deg"], float(angle_deg(
                res["R_avg"][f].astype(np.float64), R_avg)))
    for f, fr in enumerate(truth):
        valid = np.asarray(res["valid"][f], bool)
        anchor = np.flatnonzero(valid & (res["ids"][f] == pcfg["anchor_id"]))
        if len(anchor) == 0 or int(res["anchor_idx"][f]) != int(anchor[0]):
            out["anchor_wrong"] += 1
            continue
        if depths is None:
            continue
        P = anchor_position(res["anchor_t"][f], depths[f], K,
                            pcfg["depth_scale"], pcfg["center_win"],
                            pcfg["fallback_win"])
        out["anchor_mm"] = max(out["anchor_mm"], float(
            1e3 * np.abs(res["anchor_P"][f].astype(np.float64) - P).max()))
    if clouds:
        xyz, col = 0.0, 0.0
        for f, pc in clouds.items():
            ref = cloud(depths[f], rgbs[f], K, pcfg["depth_scale"])
            d = np.abs(pc.astype(np.float64) - ref)
            xyz = max(xyz, float(d[:3].max()))
            col = max(col, float(d[3:].max()))
        out["cloud_mm"] = 1e3 * xyz
        out["color_gap"] = col
    return out


def control(truth: list, cam, pcfg: dict, rgbs, depths, cloud_frames,
            slots: int, dtype=torch.bfloat16) -> tuple[dict, dict]:
    """The reference in the program's place, computed in `dtype`: the
    rendered ids in the first slots, their projected corners, poses (with
    the flip), the fused rotation, the anchor and the clouds of
    `cloud_frames`. Returns (outputs shaped as ``judge`` reads them,
    {frame: cloud})."""
    from benchmark.scene import distort as distort_any

    n = len(truth)

    def c(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype)

    K = c(cam.K)
    size = pcfg["tag_size_m"]
    obj = c(OBJ_ORDER * (size / 2))
    flips = set(pcfg["flip_z_ids"])
    res = dict(ids=np.full((n, slots), -1, np.int32),
               valid=np.zeros((n, slots), bool),
               corners=np.zeros((n, slots, 4, 2), np.float32),
               areas=np.zeros((n, slots), np.float32),
               R=np.tile(np.eye(3, dtype=np.float32), (n, slots, 1, 1)),
               t=np.zeros((n, slots, 3), np.float32),
               R_avg=np.zeros((n, 3, 3), np.float32),
               anchor_idx=np.zeros(n, np.int32),
               anchor_t=np.zeros((n, 3), np.float32),
               anchor_P=np.zeros((n, 3), np.float32))
    low = lambda x: x.to(torch.float32).numpy()  # noqa: E731
    for f, fr in enumerate(truth):
        qs, ws = [], []
        for s, (i, R, t) in enumerate(zip(fr.ids, fr.R, fr.t)):
            Rd, td = c(R), c(t)
            X = obj @ Rd.T + td
            x, y = X[:, 0] / X[:, 2], X[:, 1] / X[:, 2]
            if cam.dist is not None:
                x, y = distort_any(x, y, cam.dist)
            uv = torch.stack([K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]], -1)
            if i in flips:
                Rd = Rd * c(FLIP)
            res["ids"][f, s], res["valid"][f, s] = i, True
            res["corners"][f, s] = low(uv)
            area = 0.5 * torch.abs((uv[:, 0] * torch.roll(uv[:, 1], -1, 0)
                                    - torch.roll(uv[:, 0], -1, 0) * uv[:, 1]
                                    ).sum())
            res["areas"][f, s] = low(area)
            res["R"][f, s], res["t"][f, s] = low(Rd), low(td)
            # the reference's weight, area over the mean corner residual
            # of the pose on these corners, in the same precision
            Ru = Rd * c(FLIP) if i in flips else Rd
            Xp = obj @ Ru.T + td
            xp, yp = Xp[:, 0] / Xp[:, 2], Xp[:, 1] / Xp[:, 2]
            if cam.dist is not None:
                xp, yp = distort_any(xp, yp, cam.dist)
            pp = torch.stack([K[0, 0] * xp + K[0, 2], K[1, 1] * yp + K[1, 2]],
                             -1)
            err = torch.linalg.vector_norm((pp - uv).to(torch.float32),
                                           dim=-1).mean().to(dtype)
            qs.append(torch.as_tensor(quat(low(Rd).astype(np.float64))).to(
                dtype))
            ws.append(torch.clamp(area, min=1e-3) / torch.clamp(err, min=1e-3))
            if i == pcfg["anchor_id"]:
                res["anchor_idx"][f] = s
                res["anchor_t"][f] = low(td)
                res["anchor_P"][f] = anchor_position(
                    low(td).astype(np.float64), depths[f], cam.K,
                    pcfg["depth_scale"], pcfg["center_win"],
                    pcfg["fallback_win"], rnd=rounding(dtype),
                    out=rounding(dtype))
        q = torch.stack(qs)
        q = q * torch.where((q * q[0]).sum(-1, keepdim=True) < 0, -1.0, 1.0
                            ).to(dtype)
        qa = (torch.stack(ws)[:, None] * q).sum(0)
        qa = qa / torch.linalg.vector_norm(qa.to(torch.float32)).to(dtype)
        res["R_avg"][f] = quat_to_R(low(qa).astype(np.float64))
    clouds = {}
    for f in cloud_frames:
        d = torch.as_tensor(depths[f].astype(np.float32)).to(dtype)
        z = d * c(pcfg["depth_scale"])
        h, w = z.shape
        u = torch.arange(w).to(dtype)[None, :]
        v = torch.arange(h).to(dtype)[:, None]
        rgb = torch.as_tensor(rgbs[f].astype(np.float32)).to(dtype)
        col = rgb / c(255.0) * (z > 0)[..., None].to(dtype)
        pc = torch.stack([(u - K[0, 2]) * z / K[0, 0],
                          (v - K[1, 2]) * z / K[1, 1], z, col[..., 0],
                          col[..., 1], col[..., 2]]).reshape(6, -1)
        clouds[f] = low(pc)
    return res, clouds


def rounding(dtype):
    """Elementwise rounding of float64 numpy values to `dtype`."""
    def rnd(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).to(
            torch.float64).numpy()
    return rnd
