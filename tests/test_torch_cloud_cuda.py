"""The point-cloud registration path on the card against the port on the
CPU, at test size (``chip_smoke.py``'s registration checks).

Marked ``cuda``: they skip where torch sees no CUDA device. On a machine
with a card: ``python -m pytest -m cuda tests/test_torch_cloud_cuda.py``.
Tolerances: ICP's T within 1e-5 m and 1e-3 degrees, fitness within 1e-4;
RANSAC on one set of picks: the same best hypothesis, T within 1e-5;
grid NN equal wherever the best target beats the runner-up by more than
1e-6 m, distances within 1e-6; voxel representatives equal and means
within 1e-6 (the card sums with atomics, in another order); outlier and
normal masks on one sample equal. Compiled against eager on the card
(``core.jit``: each stage a captured graph, ICP's loop one WHILE node):
ICP bit-equal with the same iterations, also when it runs to max_iters
(masked source points: C9's NaN RMSE); register_clouds' T within 1e-5 m
and 1e-3 degrees (the voxel means' atomics).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.cloud import filters, fpfh, knn, normals  # noqa: E402
from repas_tpu_torch.cloud import registration as reg  # noqa: E402
from repas_tpu_torch.core.jit import disable_jit  # noqa: E402
from repas_tpu_torch.core.transforms import make_T, rodrigues  # noqa: E402

pytestmark = pytest.mark.cuda

RV = (0.04, -0.06, 0.30)
T_TRUE = (0.06, -0.04, 0.05)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _scene(n, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(-0.5, 0.5, n),
                           rng.uniform(-0.5, 0.5, n),
                           np.zeros(n)]).astype(np.float32)
    pts[:, 2] = (0.08 * np.sin(7 * pts[:, 0]) * np.cos(5 * pts[:, 1])
                 + 0.05 * pts[:, 0] ** 2)
    R = rodrigues(torch.tensor(RV)).numpy()
    t = np.array(T_TRUE, np.float32)
    src = ((pts - t) @ R).astype(np.float32)
    return torch.from_numpy(src), torch.from_numpy(pts), R, t


def _angle_deg(Ra, Rb):
    """Angle of Ra^T Rb, atan2(|sin|, cos) in float64 (arccos of the trace
    turns one ulp into a hundredth of a degree near 0)."""
    Rr = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    return float(np.degrees(np.arctan2(np.linalg.norm(w),
                                       (np.trace(Rr) - 1) / 2)))


def test_icp_on_card_matches_cpu(dev):
    src, tgt, R, t = _scene(8000)
    mask = torch.ones(8000, dtype=torch.bool)
    nrm, _ = normals.estimate_normals_grid(tgt, mask, k=16, radius=0.06)
    T_init = make_T(rodrigues(torch.tensor(RV) + torch.tensor(
        [0.01, -0.01, 0.005])), torch.tensor(t) + 0.003).numpy()
    args = (src, mask, tgt, mask, nrm)
    rc = reg.icp_point_to_plane(*args, max_corr_dist=0.045, max_iters=30,
                                T_init=T_init)
    rg = reg.icp_point_to_plane(*(a.to(dev) for a in args),
                                max_corr_dist=0.045, max_iters=30,
                                T_init=T_init)
    Tc, Tg = rc.T.numpy(), rg.T.cpu().numpy()
    assert np.abs(Tc[:3, 3] - Tg[:3, 3]).max() <= 1e-5
    assert _angle_deg(Tc[:3, :3], Tg[:3, :3]) <= 1e-3
    assert abs(float(rc.fitness) - float(rg.fitness)) <= 1e-4
    assert np.abs(Tg[:3, 3] - t).max() < 1e-3


def test_ransac_and_grid_query_on_card_match_cpu(dev):
    src, tgt, R, t = _scene(8000, seed=1)
    mask = torch.ones(8000, dtype=torch.bool)
    voxel = 0.03
    clouds = []
    for pts in (src, tgt):
        pd, _, _, md = filters.voxel_downsample(pts, mask, voxel)
        pc, mc, _ = filters.compact_masked(pd, md, 2048)
        n_c, _ = normals.estimate_normals_grid(pc, mc, k=24, radius=0.06,
                                               dims=(32, 32, 32), slots=32)
        clouds.append((pc, mc, fpfh.fpfh_features(
            pc, n_c, mc, radius=0.15, k=48, dims=(32, 32, 32), slots=32)))
    (sp, sm, sf), (tp, tm, tf) = clouds
    corr, _ = fpfh.match_features(sf, sm, tf, tm)
    corr_g, _ = fpfh.match_features(*(a.to(dev) for a in (sf, sm, tf, tm)))
    assert (corr_g.cpu() == corr).float().mean() > 0.99
    gen = filters._generator("cpu", 7)
    ok = sm & (corr >= 0)
    picks = filters._choice(ok, 3 * 2048, True, gen).reshape(2048, 3)
    ev = filters._choice(ok, 1024, True, gen)
    args = (sp, sm, tp, tm, corr)
    rc = fpfh._ransac_from_picks(*args, 0.075, 0.9, picks, ev)
    rg = fpfh._ransac_from_picks(*(a.to(dev) for a in args), 0.075, 0.9,
                                 picks.to(dev), ev.to(dev))
    assert int(rc[3]) == int(rg[3])
    assert float((rc[0] - rg[0].cpu()).abs().max()) <= 1e-5

    q = torch.from_numpy((src.numpy() @ R.T + t + np.random.default_rng(
        2).normal(0, 0.002, (8000, 3))).astype(np.float32))
    g2 = knn.grid2_build(tgt, mask, 0.045)
    nn_c, d_c = knn.grid2_query(g2, tgt, q, mask)
    g2g = knn.grid2_build(tgt.to(dev), mask.to(dev), 0.045)
    nn_g, d_g = (v.cpu() for v in knn.grid2_query(g2g, tgt.to(dev),
                                                  q.to(dev), mask.to(dev)))
    two = torch.topk(torch.cdist(q, tgt), 2, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-6
    assert torch.equal(nn_c[clear], nn_g[clear])
    fin = torch.isfinite(d_c)
    assert torch.equal(fin, torch.isfinite(d_g))
    assert float((d_c - d_g)[fin].abs().max()) <= 1e-6


def test_capture_filters_on_card_match_cpu(dev):
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(np.column_stack([
        rng.uniform(-0.3, 0.3, 60000), rng.uniform(-0.2, 0.2, 60000),
        0.6 + rng.normal(0, 0.002, 60000)]).astype(np.float32))
    valid = torch.from_numpy(rng.random(60000) > 0.1)
    pc, _, _, rc = filters.voxel_downsample(pts, valid, 0.005)
    pg, _, _, rg = (None if v is None else v.cpu() for v in
                    filters.voxel_downsample(pts.to(dev), valid.to(dev),
                                             0.005))
    assert torch.equal(rc, rg)
    assert float((pc - pg)[rc].abs().max()) <= 1e-6
    idx = filters._choice(rc, 2048, False, filters._generator("cpu", 0))
    oc = filters._outlier_mask_from_sample(pc, rc, idx, 20, 2.0)
    og = filters._outlier_mask_from_sample(pc.to(dev), rc.to(dev),
                                           idx.to(dev), 20, 2.0).cpu()
    assert torch.equal(oc, og)
    idx = filters._choice(oc, 4096, False, filters._generator("cpu", 1))
    nc, okc = normals._normals_from_sample(pc, oc, idx, 30, 0.02, None)
    ng, okg = (v.cpu() for v in normals._normals_from_sample(
        pc.to(dev), oc.to(dev), idx.to(dev), 30, 0.02, None))
    assert torch.equal(okc, okg)
    assert float((nc - ng)[okc].abs().max()) <= 1e-4


def test_register_clouds_takes_numpy_to_the_card(dev):
    src, tgt, R, t = _scene(30000, seed=4)
    mask = np.ones(30000, bool)
    res, fit, voxel = reg.register_clouds(src.numpy(), mask, tgt.numpy(),
                                          mask, icp_iters=30)
    assert res.T.device.type == "cuda"
    T = res.T.cpu().numpy()
    assert float(res.fitness) > 0.5
    assert np.abs(T[:3, 3] - t).max() < 1e-3
    assert _angle_deg(T[:3, :3], R) < 0.05


@pytest.mark.parametrize("masked", [False, True])
def test_compiled_icp_equals_eager(dev, masked):
    src, tgt, R, t = _scene(8000)
    src, tgt = src.to(dev), tgt.to(dev)
    mask = torch.ones(8000, dtype=torch.bool, device=dev)
    smask = mask.clone()
    if masked:
        smask[::50] = False
    nrm, _ = normals.estimate_normals_grid(tgt, mask, k=16, radius=0.06)
    T_init = make_T(rodrigues(torch.tensor(RV) + torch.tensor(
        [0.01, -0.01, 0.005])), torch.tensor(t) + 0.003).numpy()
    reg._icp.clear()

    def icp():
        return reg.icp_point_to_plane(src, smask, tgt, mask, nrm,
                                      max_corr_dist=0.045, max_iters=12,
                                      T_init=T_init)

    icp()                                                   # captures
    got = icp()
    with disable_jit():
        want = icp()
    assert got.iterations == want.iterations
    assert (got.iterations == 12) == masked
    assert torch.equal(got.T, want.T)
    assert np.isnan(float(got.inlier_rmse)) == masked
    entry = next(iter(reg._icp.graphs.values()))
    assert len(entry.while_nodes) == 1 and entry.while_nodes[0] > 20


def test_compiled_register_clouds_equals_eager(dev):
    src, tgt, R, t = _scene(20000, seed=2)
    mask = torch.ones(20000, dtype=torch.bool, device=dev)
    args = [src.to(dev), mask, tgt.to(dev), mask]
    reg.register_clouds(*args, seed=3)                      # captures
    got, fit, _ = reg.register_clouds(*args, seed=3)
    with disable_jit():
        want, fit_e, _ = reg.register_clouds(*args, seed=3)
    Tg, Te = got.T.cpu().numpy(), want.T.cpu().numpy()
    assert np.abs(Tg[:3, 3] - Te[:3, 3]).max() <= 1e-5
    assert _angle_deg(Tg[:3, :3], Te[:3, :3]) <= 1e-3
    assert np.abs(Tg[:3, 3] - t).max() < 1e-3
