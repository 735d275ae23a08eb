"""Synthetic scenes shared by the canopy, calibration and surface-error
tests of the port, built from a numpy seed with numpy and the port only
(no jax, no cv2), so the card's tests can use them too; and checks of the
scenes themselves.

- ``tilted_scene``: a 240x320 canopy capture (tilted bar, plant body with
  a 2 px leaf tip, depth with the plant and bar near and the background
  2 m behind);
- ``render_view``: a checkerboard seen through a Brown-Conrady lens
  (supersampled, blurred, noisy), and ``board_pose``;
- ``synth_views``: tests/test_calibration.py's synthetic corner views;
- ``uv_sphere``: a closed UV sphere wound counter-clockwise from outside.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

COLS, ROWS, SQUARE = 9, 7, 0.0127
K_CAL = np.array([[600.0, 0, 322.0], [0, 599.0, 241.5], [0, 0, 1.0]])


def tilted_scene(angle_deg, seed, h=240, w=320):
    """A noisy capture: a 5 px bar tilted by angle_deg, a green body with a
    2 px leaf tip 10 px long on top, depth 0.9 m on the plant and bar (its
    edges 4 px outside the colour's) and 2.9 m behind, 2 mm noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rgb = rng.normal(120, 3, (h, w, 3))
    yc = 0.8 * h + np.tan(np.deg2rad(angle_deg)) * (xx - w / 2)
    bar = (np.abs(yy - yc) <= 2) & (xx >= 0.05 * w) & (xx <= 0.95 * w)
    rgb[bar] = 235 + rng.normal(0, 3, (bar.sum(), 3))
    body = ((xx - w / 2) / 50) ** 2 + ((yy - 0.45 * h) / 40) ** 2 < 1
    top = 0.45 * h - 40
    tip = ((np.abs(xx - (w / 2 + 0.5)) <= 1) & (yy >= top - 10)
           & (yy <= top + 2))
    plant = body | tip
    rgb[plant] = [45, 165, 55] + rng.normal(0, 4, (plant.sum(), 3))
    rgb = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    near = plant | bar
    for _ in range(4):
        near = near | np.roll(near, 1, 0) | np.roll(near, -1, 0)
        near = near | np.roll(near, 1, 1) | np.roll(near, -1, 1)
    depth = np.where(near, 0.9, 2.9) + rng.normal(0, 0.002, (h, w))
    return rgb, depth.astype(np.float32)


def _rot(rx, ry, rz):
    def R(axis, a):
        c, s = np.cos(a), np.sin(a)
        i, j = [k for k in range(3) if k != axis]
        m = np.eye(3)
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m
    return R(2, rz) @ R(0, rx) @ R(1, ry)


def _undistort(x, y, dist, iters=20):
    k1, k2, p1, p2, k3 = dist
    xu, yu = x.copy(), y.copy()
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu, yu = (x - dx) / rad, (y - dy) / rad
    return xu, yu


def render_view(K, dist, R, t, size=(640, 480), cols=COLS, rows=ROWS,
                square=SQUARE, ss=2, blur=0.8, noise=1.0, seed=0):
    """A board image (H,W) float32 of u8 levels: (cols+1)x(rows+1) squares
    from the origin of the board plane, white surround; each supersample's
    ray undistorted and met with the plane."""
    w, h = size
    u = (np.arange(w * ss) + 0.5) / ss - 0.5
    v = (np.arange(h * ss) + 0.5) / ss - 0.5
    uu, vv = np.meshgrid(u, v)
    x, y = _undistort((uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1],
                      dist)
    M = np.column_stack([R[:, 0], R[:, 1], t])
    b = np.linalg.solve(M, np.stack([x.ravel(), y.ravel(),
                                     np.ones(x.size)]))
    X, Y = b[0] / b[2], b[1] / b[2]
    i, j = np.floor(X / square), np.floor(Y / square)
    inside = (i >= 0) & (i <= cols) & (j >= 0) & (j <= rows)
    img = np.where(((i + j) % 2 == 0) & inside, 45.0, 205.0)
    img = img.reshape(h, ss, w, ss).mean((1, 3))
    if blur > 0:
        r = int(3 * blur + 0.5)
        k = np.exp(-0.5 * (np.arange(-r, r + 1) / blur) ** 2)
        k /= k.sum()
        img = np.apply_along_axis(lambda a: np.convolve(
            np.pad(a, r, mode="edge"), k, "valid"), 1, img)
        img = np.apply_along_axis(lambda a: np.convolve(
            np.pad(a, r, mode="edge"), k, "valid"), 0, img)
    img = img + np.random.default_rng(seed).normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)


def board_pose(tilt, yaw, roll, z, dx=0.0, dy=0.0):
    """Board rotation and translation: tilted, yawed and rolled (degrees)
    about its centre, which sits at (dx, dy, z)."""
    R = _rot(np.radians(tilt), np.radians(yaw), np.radians(roll))
    c = np.array([(COLS + 1) * SQUARE / 2, (ROWS + 1) * SQUARE / 2, 0.0])
    return R, np.array([dx, dy, z]) - R @ c


def board_truth(K, dist, R, t, cols=COLS, rows=ROWS, square=SQUARE):
    """The inner corners' pixels (row-major) through the port's lens."""
    from repas_tpu_torch.kernels.project import project_points
    xx, yy = np.meshgrid(np.arange(1, cols + 1), np.arange(1, rows + 1))
    obj = np.column_stack([xx.ravel() * square, yy.ravel() * square,
                           np.zeros(xx.size)])
    return project_points(torch.tensor(obj, dtype=torch.float64),
                          torch.tensor(R), torch.tensor(t),
                          torch.tensor(K), torch.tensor(dist)).numpy()


def synth_views(n_views, cols=9, rows=7, noise=0.0, seed=0):
    """tests/test_calibration.py's synthetic views (K 760/758, dist
    (0.09, -0.11, 0.001, 0.002, 0.04)), projected with the port."""
    from repas_tpu_torch.core.transforms import rodrigues
    from repas_tpu_torch.kernels.project import project_points
    K = torch.tensor([[760.0, 0, 640.0], [0, 758.0, 360.0], [0, 0, 1.0]])
    dist = torch.tensor([0.09, -0.11, 0.001, 0.002, 0.04])
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(cols), np.arange(rows))
    obj = np.column_stack([xx.reshape(-1) * SQUARE, yy.reshape(-1) * SQUARE,
                           np.zeros(cols * rows)]).astype(np.float32)
    objs, imgs = [], []
    for _ in range(n_views):
        rv = rng.normal(size=3)
        rv = (rv / np.linalg.norm(rv) * rng.uniform(0.1, 0.5)).astype(
            np.float32)
        t = -rodrigues(torch.from_numpy(rv)).numpy() @ obj.mean(axis=0)
        t = (t + [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                  rng.uniform(0.4, 0.8)]).astype(np.float32)
        uv = project_points(torch.from_numpy(obj), torch.from_numpy(rv),
                            torch.from_numpy(t), K, dist).numpy()
        uv = uv + rng.normal(scale=noise, size=uv.shape)
        objs.append(obj)
        imgs.append(uv.astype(np.float32))
    return np.stack(objs), np.stack(imgs)


def uv_sphere(n_lat, n_lon, r=0.1):
    """A closed UV sphere: vertices (V,3), triangles (F,3) wound
    counter-clockwise seen from outside (outward normals)."""
    th = np.pi * np.arange(1, n_lat) / n_lat
    ph = 2 * np.pi * np.arange(n_lon) / n_lon
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                     np.sin(th)[:, None] * np.sin(ph)[None],
                     np.cos(th)[:, None] * np.ones(n_lon)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1.0]], ring, [[0, 0, -1.0]]]) * r

    def idx(i, j):
        return 1 + i * n_lon + (j % n_lon)
    tris = []
    for j in range(n_lon):
        tris.append([0, idx(0, j), idx(0, j + 1)])
        tris.append([len(verts) - 1, idx(n_lat - 2, j + 1),
                     idx(n_lat - 2, j)])
        for i in range(n_lat - 2):
            a, b = idx(i, j), idx(i, j + 1)
            c, d = idx(i + 1, j), idx(i + 1, j + 1)
            tris += [[a, c, d], [a, d, b]]
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def test_uv_sphere_closed_and_outward():
    verts, tris = uv_sphere(12, 18)
    e = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                tris[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()
    a, b, c = (verts[tris[:, k]] for k in range(3))
    n = np.cross(b - a, c - a)
    assert (np.sum(n * (a + b + c), axis=1) > 0).all()


def test_board_render_has_corners_at_truth():
    """Each rendered inner corner is a saddle: its four diagonal
    neighbours 3 px away alternate dark and light."""
    R, t = board_pose(20, 10, 5, 0.55)
    dist = np.array([-0.2, 0.07, 0.0, 0.0, 0.0])
    img = render_view(K_CAL, dist, R, t, blur=0.0, noise=0.0)
    uv = board_truth(K_CAL, dist, R, t)
    assert (uv.min(0) > 10).all() and (uv.max(0) < [630, 470]).all()
    for u, v in np.round(uv).astype(int)[::7]:
        q = [img[v - 3, u - 3], img[v - 3, u + 3], img[v + 3, u + 3],
             img[v + 3, u - 3]]
        assert (q[0] - q[1]) * (q[2] - q[1]) > 0 and abs(q[0] - q[1]) > 100


@pytest.mark.parametrize("angle", [6.0, -9.0])
def test_tilted_scene_layout(angle):
    rgb, depth = tilted_scene(angle, 1)
    green = (rgb[..., 1] > 140) & (rgb[..., 0] < 80)
    assert green[:, 160:162].any(axis=1).argmax() == int(0.45 * 240 - 50)
    assert np.isclose(np.median(depth[green]), 0.9, atol=0.01)
