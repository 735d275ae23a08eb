"""The CAD-placement and reconstruction path on the card against the port on
the CPU, at test size (``chip_smoke.py``'s cad_chain checks).

Marked ``cuda``: they skip where torch sees no CUDA device. On a machine
with a card: ``python -m pytest -m cuda tests/test_torch_cad_cuda.py``.
Tolerances: Poisson chi within 1e-5 of max |chi| (the splat's atomics
and cuFFT sum in another order); ``refine_with_icp`` fed one normals
sample, for a fixed count of iterations (near its fixed point ICP may
cycle at rounding level, and the devices would stop on different steps
of the cycle): T within 1e-6 m and 1e-4 degrees, fitness within 1e-6;
``ball_pivot``'s face set equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.cloud import cad, normals, reconstruct  # noqa: E402
from repas_tpu_torch.cloud.filters import _choice, _generator  # noqa: E402
from repas_tpu_torch.core.config import ICPConfig  # noqa: E402
from repas_tpu_torch.io.ply import PointCloud  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _sphere(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * 0.1 + [0, 0, 0.5]).astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("dim", [64, 128])
def test_poisson_on_card_matches_cpu(dev, dim):
    pts, nrm = _sphere(20000)
    lo, hi = pts.min(0), pts.max(0)
    span = float((hi - lo).max()) * 1.2
    lo, cell = (lo + hi) / 2 - span / 2, span / dim
    args = (torch.from_numpy(pts), torch.from_numpy(nrm),
            torch.ones(len(pts), dtype=torch.bool))
    cc = reconstruct.poisson_indicator_grid(*args, lo, cell, dim=dim)
    cg = reconstruct.poisson_indicator_grid(*(a.to(dev) for a in args), lo,
                                            cell, dim=dim).cpu()
    assert float((cc - cg).abs().max()) <= 1e-5 * float(cc.abs().max())


def test_refine_with_icp_on_card_matches_cpu(dev, monkeypatch):
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.15, 0.15, (20000, 2))
    scene = np.column_stack([xy, 0.5 + 0.03 * np.sin(20 * xy[:, 0])
                             * np.cos(16 * xy[:, 1])])
    cad_pts = scene[::3] + [0.003, -0.002, 0.002]
    fixed = {}

    def one_sample(pts, mask, k=30, radius=0.02, **_):
        # the same drawn indices on both devices
        if "idx" not in fixed:
            fixed["idx"] = _choice(mask.cpu(), min(4096, len(mask)), False,
                                   _generator("cpu", 1))
        return normals._normals_from_sample(
            pts, mask, fixed["idx"].to(pts.device), k, radius, None)

    monkeypatch.setattr(cad, "estimate_normals", one_sample)
    cfg = ICPConfig(cad_samples=5000, rel_tol=0.0, max_iters=30)
    rc, Tc = cad.refine_with_icp(PointCloud(points=cad_pts),
                                 PointCloud(points=scene), cfg, device="cpu")
    rg, Tg = cad.refine_with_icp(PointCloud(points=cad_pts),
                                 PointCloud(points=scene), cfg, device=dev)
    assert np.abs(Tc[:3, 3] - Tg[:3, 3]).max() <= 1e-6
    Rr = Tc[:3, :3].T @ Tg[:3, :3]
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    assert np.degrees(np.arctan2(np.linalg.norm(w),
                                 (np.trace(Rr) - 1) / 2)) <= 1e-4
    assert abs(rc["fitness"] - rg["fitness"]) <= 1e-6
    assert np.abs(Tg[:3, 3] + [0.003, -0.002, 0.002]).max() < 1e-3


def test_ball_pivot_on_card_matches_cpu(dev):
    pts, nrm = _sphere(3000, seed=2)
    pc = PointCloud(points=pts, normals=nrm)
    bc = reconstruct.ball_pivot(pc, device="cpu")
    bg = reconstruct.ball_pivot(pc, device=dev)
    np.testing.assert_array_equal(bg.triangles, bc.triangles)
    assert len(bg.triangles) > 3000
