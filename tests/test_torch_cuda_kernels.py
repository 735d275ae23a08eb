"""The hand-written CUDA kernels (B1 CCL, B2 patch extraction, B3 point
cloud, B4 segmented scans and tiled CCL, B5 and B6 the window copies of
the measurement tool micro_perf, K1 the 3x3 eigh, K2 the Kabsch
rotation and K3 the 9x9 eigh) against their plain PyTorch versions, on
the card; the window copies on each of their paths (vector, TMA, element
by element) and at negative and edge starts; SQPnP and the tag bundle on
the card without a torch.linalg solve, eigh, SVD or det, compiled and
replayed without a host read, against the CPU port.

Marked ``cuda``: they skip where torch sees no CUDA device. On a machine
with a card: ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Tolerances: B1, B2, B4, B5 and B6 exact; B3 rtol 1e-6 (same formula,
same order). K1 and K2 compute in float64 and round once: against their
plain versions run in float64, eigenvalues within 1e-5 of the largest,
the smallest eigenvector within 1e-4 rad where the two smallest
eigenvalues are over 1e-6 of the trace apart (else |Av - lv| within
1e-5 |A|), R within 1e-5 where sigma2 > 1e-6 sigma1, det R = 1 within
1e-5 everywhere. K3 likewise against torch.linalg.eigh in float64:
eigenvalues within 1e-5 (float32 input; 1e-12 for float64 input) of the
largest |eigenvalue|, eigenvectors up to sign (1 - |v.v'| within 1e-5,
1e-10 for float64) where the eigenvalue's gap to its neighbours is over
1e-4 of the largest, |AV - VL| within 1e-5 |A|, V orthonormal within
1e-5, at most 16 sweeps. SQPnP on 16 non-coplanar problems: R within
0.01 degrees and t within 0.1 mm of the CPU port; the compiled step
bit-equal to the eager call on the card.
A mask density of -1 makes an all-foreground mask, 1 an all-background one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.kernels import _build, ccl, ccl_cuda  # noqa: E402
from repas_tpu_torch.kernels import ccl_tiled  # noqa: E402
from repas_tpu_torch.kernels import patch_extract, pointcloud  # noqa: E402
from repas_tpu_torch.kernels.eig3 import eig3, eig3_plain  # noqa: E402
from repas_tpu_torch.kernels.eig9 import eig9, eig9_plain  # noqa: E402
from repas_tpu_torch.kernels.kabsch3 import (kabsch3,  # noqa: E402
                                             kabsch3_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,density,iters", [
    ((16, 360, 640), 0.55, 5),       # the main path's shape
    ((16, 256, 256), 0.55, 5),       # the robust ladder's stage-B ROIs
    ((2, 720, 1280), 0.5, 5),        # full resolution, through B1
    ((3, 37, 53), 0.4, 1),           # odd sizes, partial warps
    ((1, 64, 33), 0.3, 4),
    ((8, 360, 640), 0.55, 5),        # the ladder's stage A
    ((1, 724, 724), 0.5, 5),         # a cluster over 8 (non-portable)
    ((16, 360, 640), -1.0, 5),       # all foreground
    ((16, 360, 640), 1.0, 5),        # all background
    ((12, 720, 1280), 0.5, 5),       # several grid groups
    ((1, 360, 640), 0.55, 5),        # the tracker's registration
    ((1, 256, 256), 0.55, 5),        # the tracker's ROI step
])
def test_ccl_kernel_matches_plain(dev, shape, density, iters):
    rng = np.random.default_rng(0)
    mask = torch.from_numpy(rng.random(shape) > density).to(dev)
    before = _build.launches["ccl"]
    got = ccl_cuda.connected_components_cuda(mask, iters)
    assert _build.launches["ccl"] == before + 1
    ref = ccl.connected_components_plain(mask, iters)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(ccl.connected_components(mask, iters), ref)


@pytest.mark.parametrize("shape,density", [
    ((4, 720, 1280), 0.5),           # the robust ladder's full resolution
    ((1, 1025, 517), 0.4),           # odd sizes: partial chunks and warps
    ((2, 37, 70), 0.6),
])
@pytest.mark.parametrize("dim", [2, 1])
def test_seg_scan_kernel_matches_plain_on_any_labels(dev, shape, density,
                                                     dim):
    """B4's unit on random labels: background labels and labels above the
    sentinel included."""
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random(shape) > density).to(dev)
    n = shape[1] * shape[2]
    labels = torch.from_numpy(rng.integers(0, 2 * n, shape).astype(
        np.int32)).to(dev)
    before = _build.launches["ccl_tiled"]
    got = ccl_tiled.seg_scan_axis_cuda(mask, labels, dim)
    assert _build.launches["ccl_tiled"] == before + 1
    ref = ccl_tiled.seg_scan_axis_plain(mask, labels, dim)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,density,iters", [
    ((2, 720, 1280), 0.5, 5),
    ((1, 1025, 517), 0.45, 3),
    ((3, 40, 33), 0.4, 1),
    ((8, 360, 640), 0.55, 5),
    ((1, 724, 724), 0.5, 5),
    ((4, 720, 1280), -1.0, 5),       # all foreground
    ((4, 720, 1280), 1.0, 5),        # all background
    ((12, 720, 1280), 0.5, 5),       # several grid groups
])
def test_tiled_ccl_matches_b1_and_plain(dev, shape, density, iters):
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random(shape) > density).to(dev)
    before = _build.launches["ccl_tiled"]
    got = ccl_tiled.connected_components_tiled_cuda(mask, iters)
    assert _build.launches["ccl_tiled"] == before + 1
    b1 = ccl_cuda.connected_components_cuda(mask, iters)
    torch.cuda.synchronize()
    assert torch.equal(got, b1)
    assert torch.equal(got, ccl_tiled.connected_components_tiled_plain(
        mask, iters))


@pytest.mark.parametrize("shape", [(1, 360, 640), (1, 256, 256)])
def test_ccl_plan_for_one_image(dev, shape):
    """A single image (the tracker's shapes) takes one cluster: one
    launch, bands covering every row."""
    mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    plan = ccl_cuda.plan_for(mask)
    print(shape, plan)
    assert plan.mode == "cluster" and plan.launches == 1 and plan.group == 1
    assert plan.bands == plan.cluster
    assert plan.bands * plan.band_rows >= shape[1]


def test_band_ccl_refused_launch_raises(dev):
    """A launch the card refuses raises in the wrapper: a cooperative
    launch of more bands than the SMs hold, a cluster over 16 CTAs."""
    mask = torch.ones((64, 720, 64), dtype=torch.bool, device=dev)
    too_many = ccl_cuda.BandPlan("grid", 0, 1, 720, 64, 1,
                                 ccl_cuda.band_smem(1, 64, False))
    with pytest.raises(RuntimeError, match="repas_ccl"):
        ccl_cuda.run_plan(mask, 1, too_many)
    too_wide = ccl_cuda.BandPlan("cluster", 32, 23, 32, 64, 1,
                                 ccl_cuda.band_smem(23, 64, True))
    with pytest.raises(RuntimeError, match="repas_ccl"):
        ccl_cuda.run_plan(mask, 1, too_wide)


def _turned_tag_masks(shape, seed):
    """(B,H,W) dark masks of rendered tags turned in plane: 1-4 tags a
    frame of 30-110 px (the 61-220 px tags of a 720p frame at the
    detector's decimation 2), any turn, noise sigma 2, thresholded."""
    from repas_tpu_torch.detect.render import render_tag_in_scene

    B, h, w = shape
    rng = np.random.default_rng(seed)
    f, z = 500.0, 1.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    masks = []
    for _ in range(B):
        img = np.full((h, w), 180.0, np.float32)
        for _ in range(int(rng.integers(1, 5))):
            side = rng.uniform(30, 110)
            a = rng.uniform(-np.pi, np.pi)
            R = np.array([[np.cos(a), -np.sin(a), 0],
                          [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
            t = np.array([rng.uniform(-0.35, 0.35) * w / f,
                          rng.uniform(-0.3, 0.3) * h / f, z])
            g = render_tag_in_scene(int(rng.integers(0, 12)), R, t, K,
                                    side * z / f, (h, w), supersample=1)
            img = np.where(np.abs(g - 180.0) > 1e-3, g, img)
        img = img + rng.normal(0, 2.0, img.shape)
        masks.append(img < 105.0)
    return torch.from_numpy(np.stack(masks))


@pytest.mark.parametrize("iters", [1, 5])
def test_ccl_kernel_converged_on_turned_tags(dev, iters):
    """B1 at the frame step's shape on rendered turned tags, run to the
    fixed point: the plain version's converged labels, and the device
    counter's rounds (at least `iters`, more than 5 rounds' labels
    needed somewhere), images and call."""
    mask = _turned_tag_masks((16, 360, 640), 11).to(dev)
    before = ccl_cuda.counts(dev)["b1"]
    got = ccl_cuda.connected_components_cuda(mask, iters, converge=True)
    after = ccl_cuda.counts(dev)["b1"]
    ref = ccl.connected_components_plain(mask.cpu(), iters, converge=True)
    assert torch.equal(got.cpu(), ref)
    assert not torch.equal(ccl.connected_components_plain(mask.cpu(), 5),
                           ref)
    assert after["images"] - before["images"] == 16
    assert after["calls"] - before["calls"] == 1
    rounds = after["rounds"] - before["rounds"]
    assert 16 * max(iters, 2) <= rounds < 16 * 64
    print("B1 converged, mean rounds an image", rounds / 16)


@pytest.mark.parametrize("shape,density,iters", [
    ((16, 360, 640), 0.55, 5),       # the main path's shape, cluster mode
    ((2, 720, 1280), 0.5, 1),        # full resolution: grid mode
    ((12, 720, 1280), 0.5, 5),       # several grid groups
    ((3, 37, 53), 0.4, 1),           # odd sizes, partial warps
    ((1, 724, 724), 0.5, 5),         # a cluster over 8 (non-portable)
    ((4, 64, 96), -1.0, 1),          # all foreground
    ((4, 64, 96), 1.0, 5),           # all background
])
def test_ccl_kernels_converged_match_plain(dev, shape, density, iters):
    """B1 and B4 run to the fixed point equal the plain version's
    converged labels; fixed-round calls count `iters` rounds an image."""
    rng = np.random.default_rng(8)
    mask = torch.from_numpy(rng.random(shape) > density).to(dev)
    ref = ccl.connected_components_plain(mask.cpu(), iters, converge=True)
    b1 = ccl_cuda.connected_components_cuda(mask, iters, converge=True)
    b4 = ccl_tiled.connected_components_tiled_cuda(mask, iters,
                                                   converge=True)
    assert torch.equal(b1.cpu(), ref) and torch.equal(b4.cpu(), ref)
    before = ccl_cuda.counts(dev)
    ccl_cuda.connected_components_cuda(mask, iters)
    ccl_tiled.connected_components_tiled_cuda(mask, iters)
    after = ccl_cuda.counts(dev)
    for k in ("b1", "b4"):
        d = {n: after[k][n] - before[k][n] for n in after[k]}
        assert d == {"rounds": iters * shape[0], "images": shape[0],
                     "calls": 1}, (k, d)


def test_ccl_converged_spiral_and_graph_replays_count(dev):
    """A one-pixel spiral needs many rounds; B1 captured in a CUDA graph
    converges in every replay, and every replay adds to the counter."""
    n = 161
    m = np.zeros((2, n, n), bool)
    lo, hi = 1, n - 2
    while lo < hi:
        m[:, lo, lo:hi + 1] = True
        m[:, lo:hi + 1, hi] = True
        m[:, hi, lo:hi + 1] = True
        m[:, lo + 2:hi + 1, lo] = True
        m[:, lo + 2, lo:lo + 3] = True    # on into the next turn
        lo, hi = lo + 2, hi - 2
    mask = torch.from_numpy(m).to(dev)
    ref = ccl.connected_components_plain(mask.cpu(), 5, converge=True)
    assert len(torch.unique(ref[0][torch.from_numpy(m[0])])) == 1
    ccl_cuda.connected_components_cuda(mask, 5, converge=True)   # plan, build
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ccl_cuda.connected_components_cuda(mask, 5, converge=True)
    before = ccl_cuda.counts(dev)["b1"]
    for _ in range(3):
        g.replay()
    after = ccl_cuda.counts(dev)["b1"]
    assert torch.equal(out.cpu(), ref)
    assert after["calls"] - before["calls"] == 3
    assert after["images"] - before["images"] == 6
    assert after["rounds"] - before["rounds"] > 6 * 20


def test_connected_components_dispatch_on_card(dev):
    """Over MAX_VMEM_PIXELS a CUDA mask launches B4, at or under it B1."""
    rng = np.random.default_rng(5)
    big = torch.from_numpy(rng.random((1, 725, 725)) > 0.5).to(dev)
    small = torch.from_numpy(rng.random((1, 512, 1024)) > 0.5).to(dev)
    _build.reset_launches()
    ccl.connected_components(big, 2)
    assert _build.launches["ccl_tiled"] == 1 and _build.launches["ccl"] == 0
    ccl.connected_components(small, 2)
    assert _build.launches["ccl_tiled"] == 1 and _build.launches["ccl"] == 1


def test_ccl_tiled_wrappers_reject_bad_inputs(dev):
    mask = torch.zeros((1, 8, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        ccl_tiled.connected_components_tiled_cuda(mask.to(torch.int32))
    with pytest.raises(ValueError):
        ccl_tiled.connected_components_tiled_cuda(mask.cpu())
    with pytest.raises(ValueError):
        ccl_tiled.connected_components_tiled_cuda(mask, iters=0)
    with pytest.raises(ValueError):        # labels of another dtype
        ccl_tiled.seg_scan_axis_cuda(mask, torch.zeros((1, 8, 8),
                                                       device=dev), 2)
    with pytest.raises(ValueError):        # the batch dim is no scan axis
        ccl_tiled.seg_scan_axis_cuda(
            mask, torch.zeros((1, 8, 8), dtype=torch.int32, device=dev), 0)


@pytest.mark.parametrize("shape,ah,aw,aligned", [
    ((16, 1536, 1280), 208, 384, True),
    ((1, 1536, 1280), 208, 384, True),   # the tracker's registration
    ((1, 480, 256), 192, 192, False),    # the tracker's ROI pyramid
    ((2, 100, 150), 64, 48, False),
    ((2, 100, 150), 63, 45, False),
])
def test_patch_extract_kernel_matches_plain(dev, shape, ah, aw, aligned):
    rng = np.random.default_rng(1)
    pyr = torch.from_numpy(rng.random(shape).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    B, hp, w = shape
    y = rng.integers(0, hp - ah + 40, (B, 48))
    x = rng.integers(0, w - aw + 1, (B, 48))
    if aligned:
        y, x = (y // 16) * 16, (x // 128) * 128
    origins = torch.from_numpy(np.stack([y, x], -1).astype(np.int32)).to(dev)
    got = patch_extract.extract_windows(pyr, origins, ah, aw)
    ref = patch_extract.extract_windows_plain(pyr, origins, ah, aw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("dtype,ph,pw,tile_h", [
    (torch.float32, 200, 384, 8),        # micro_perf's f32 windows
    (torch.bfloat16, 208, 384, 16),      # its bf16 windows
    (torch.float32, 40, 98, 8),          # element-wise path (odd width)
])
def test_patch_blk_kernel_matches_plain(dev, dtype, ph, pw, tile_h):
    rng = np.random.default_rng(4)
    pyr = torch.from_numpy(rng.standard_normal((16, 1512, 1280)).astype(
        np.float32)).to(dev).to(dtype)
    st = np.stack([rng.integers(0, (1280 - pw) // 128 + 1, (16, 48)),
                   rng.integers(0, (1512 - ph) // tile_h + 1, (16, 48))],
                  axis=-1).astype(np.int32)
    st[0, 0] = [(1280 - pw) // 128, (1512 - ph) // tile_h]
    st = torch.from_numpy(st).to(dev)
    before = _build.launches["patch_blk"]
    got = patch_extract.extract_windows_blk(pyr, st, ph, pw, tile_h)
    patch_extract.blk_origins(pyr.shape, st, ph, pw, tile_h)
    got_checked = patch_extract.extract_windows_blk(pyr, st, ph, pw, tile_h,
                                                    checked=True)
    assert _build.launches["patch_blk"] == before + 2
    ref = patch_extract.extract_windows_blk_plain(pyr, st, ph, pw, tile_h)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)
    assert torch.equal(got_checked, ref)


def test_patch_blk_kernel_refuses_a_window_past_the_edge(dev):
    pyr = torch.zeros((2, 1512, 1280), device=dev)
    st = torch.zeros((2, 3, 2), dtype=torch.int32, device=dev)
    st[1, 2, 0] = 8                      # 1024 + 384 > 1280 columns
    before = _build.launches["patch_blk"]
    with pytest.raises(ValueError, match="does not fit"):
        patch_extract.extract_windows_blk(pyr, st, 200, 384, 8)
    assert _build.launches["patch_blk"] == before


@pytest.mark.parametrize("shape,dtype", [
    ((16, 1520, 1280), torch.bfloat16),  # micro_perf's dmapatch2 section
    ((2, 100, 150), torch.float32),
])
def test_patch_exact_kernel_matches_plain(dev, shape, dtype):
    rng = np.random.default_rng(5)
    B, hp, w = shape
    pyr = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).to(dtype)
    ph, pw = min(192, hp - 8), min(192, w - 6)
    st = np.stack([rng.integers(0, w - pw + 20, (B, 48)),
                   rng.integers(0, hp - ph + 20, (B, 48))],
                  axis=-1).astype(np.int32)       # some starts clamp
    st = torch.from_numpy(st).to(dev)
    before = _build.launches["patch_exact"]
    got = patch_extract.extract_windows_exact(pyr, st, ph, pw)
    assert _build.launches["patch_exact"] == before + 1
    ref = patch_extract.extract_windows_exact_plain(pyr, st, ph, pw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)


def _tma_case(seed, shape, dtype, C, ph, pw, dev):
    """A pyramid and (B,C,2) [x, y] starts on the card: random in-range
    starts, with negative, past-the-edge and edge starts in frame 0."""
    rng = np.random.default_rng(seed)
    B, hp, w = shape
    pyr = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).to(dtype)
    st = np.stack([rng.integers(0, w - pw + 1, (B, C)),
                   rng.integers(0, hp - ph + 1, (B, C))],
                  axis=-1).astype(np.int32)
    edge = [[-1, -1], [-w, -hp], [-3 * w, 5], [w - pw, hp - ph],
            [w, hp], [10 * w, -7], [-pw, -ph], [w - pw + 1, 0]]
    st[0, :len(edge)] = edge[:C]
    return pyr, torch.from_numpy(st).to(dev)


@pytest.mark.parametrize("shape,dtype,C,ph,pw", [
    ((16, 1520, 1280), torch.bfloat16, 48, 192, 192),   # B6
    ((16, 1520, 1280), torch.float32, 48, 192, 192),    # B6 in f32
    ((1, 480, 256), torch.bfloat16, 16, 192, 192),      # the tracker's
    ((2, 300, 640), torch.bfloat16, 9, 100, 264),       # two column boxes
    ((2, 300, 640), torch.float32, 9, 37, 300),         # and a short band
    ((2, 300, 640), torch.bfloat16, 9, 37, 250),        # a narrow last box
    ((3, 90, 256), torch.bfloat16, 8, 7, 46),           # 92-byte rows
])
def test_patch_tma_matches_plain(dev, shape, dtype, C, ph, pw):
    """B6 on the TMA path, exact, at random, negative and edge starts."""
    pyr, st = _tma_case(6, shape, dtype, C, ph, pw, dev)
    path, plan = patch_extract.launch_plan(pyr, C, ph, pw)
    assert path == "tma" and plan.tasks >= plan.grid
    before = _build.launches["patch_exact"]
    got = patch_extract.extract_windows_exact(pyr, st, ph, pw)
    assert _build.launches["patch_exact"] == before + 1
    ref = patch_extract.extract_windows_exact_plain(pyr, st, ph, pw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)


def test_tracker_b2_takes_tma_and_matches_plain(dev):
    """B2 in the tracker's degraded geometry (256-column ROI pyramid,
    exact 192x192 windows at arbitrary x) through extract_patches_pyramid:
    the TMA path, one launch, exact, negative and edge starts included."""
    pyr, st = _tma_case(7, (1, 480, 256), torch.bfloat16, 16, 192, 192, dev)
    y0, x0 = st[..., 1].contiguous(), st[..., 0].contiguous()
    assert not patch_extract.aligned_ok(pyr.shape, 192, 192)
    assert patch_extract.launch_plan(pyr, 16, 192, 192)[0] == "tma"
    before = _build.launches["patch_extract"]
    got, ay, ax = patch_extract.extract_patches_pyramid(pyr, y0, x0, 192, 192)
    assert _build.launches["patch_extract"] == before + 1
    ref, ayr, axr = patch_extract.extract_patches_pyramid(
        pyr.cpu(), y0.cpu(), x0.cpu(), 192, 192)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int16), ref.view(torch.int16))
    assert torch.equal(ay.cpu(), ayr) and torch.equal(ax.cpu(), axr)


def test_patch_tma_refused_box_raises(dev):
    """A tensor map the CUDA driver refuses (a 512-row box) returns its error
    and the wrapper raises; nothing falls back to another path."""
    pyr = torch.zeros((1, 600, 256), dtype=torch.bfloat16, device=dev)
    st = torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)
    out = torch.empty((1, 1, 512, 192), dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError, match="repas_patch_extract"):
        _build.launch("repas_patch_extract", dev, pyr.data_ptr(),
                      st.data_ptr(), out.data_ptr(), 1, 1, 600, 256, 512,
                      192, 2, 1, 1, 1, 1, 512, 192, 2, 1)


def test_pointcloud_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    depth = torch.from_numpy(rng.integers(0, 4000, (3, 45, 77)).astype(
        np.uint16)).to(dev)
    rgb = torch.from_numpy(rng.integers(0, 256, (3, 45, 77, 3)).astype(
        np.uint8)).to(dev)
    K = torch.tensor([[500.0, 0, 38.5], [0, 505.0, 22.0], [0, 0, 1]],
                     device=dev)
    got = pointcloud.fused_pointcloud(depth, rgb, K, 0.001)
    ref = pointcloud.fused_pointcloud_plain(
        depth, pointcloud.pack_rgb_u32(rgb), K, 0.001)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0.0)


def test_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        ccl_cuda.connected_components_cuda(
            torch.zeros((1, 8, 8), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        patch_extract.extract_windows(
            torch.zeros((1, 8, 8), dtype=torch.float32, device=dev),
            torch.zeros((1, 2, 2), dtype=torch.int32, device=dev), 4, 4)
    with pytest.raises(ValueError):
        pointcloud.fused_pointcloud(
            torch.zeros((1, 8, 8), dtype=torch.int32, device=dev),
            torch.zeros((1, 8, 8), dtype=torch.int32, device=dev),
            torch.eye(3, device=dev))


def test_pipeline_step_has_no_host_sync(dev):
    """After one warm-up step (which copies the cached constants), a step
    issues no synchronizing CUDA call."""
    from repas_tpu_torch.detect.render import example_frame
    from repas_tpu_torch.pipeline import process_frames

    rgb, depth, K = example_frame(360, 640)
    rgbs = torch.from_numpy(rgb[None]).to(dev)
    depths = torch.from_numpy(depth[None]).to(dev)
    Kd = torch.from_numpy(K).to(dev)
    process_frames(rgbs, depths, Kd)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = process_frames(rgbs, depths, Kd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out.detections.ids[0, 0]) == 9


def test_pipeline_on_card_matches_cpu(dev):
    from repas_tpu_torch.detect.render import example_frame
    from repas_tpu_torch.pipeline import process_frames

    rgb, depth, K = example_frame(360, 640)
    rgbs, depths = torch.from_numpy(rgb[None]), torch.from_numpy(depth[None])
    cpu = process_frames(rgbs, depths, K)
    gpu = process_frames(rgbs.to(dev), depths.to(dev), K)
    assert torch.equal(gpu.detections.ids.cpu(), cpu.detections.ids)
    assert torch.equal(gpu.detections.valid.cpu(), cpu.detections.valid)
    v = cpu.detections.valid
    assert (gpu.detections.corners.cpu() - cpu.detections.corners).abs()[
        v].max() <= 0.05


def test_robust_ladder_on_card_matches_cpu(dev):
    """The staged ladder on frames that take stages A, B (two waves) and
    C: ids and valid as on the CPU, corners within 0.05 px."""
    from repas_tpu_torch.core.config import DetectorConfig
    from repas_tpu_torch.detect.render import render_tag
    from repas_tpu_torch.detect.robust import detect_tags_robust_staged

    def frame(tag_id, cell, top, left):
        img = np.full((360, 480), 235.0, np.float32)
        t = render_tag(tag_id, cell_px=cell)
        img[top:top + t.shape[0], left:left + t.shape[1]] = t
        return img

    frames = torch.from_numpy(np.stack(
        [frame(t, 3, 201, 301) for t in (11, 23, 24, 25)]
        + [frame(3, 12, 40, 60), np.full((360, 480), 128.0, np.float32)]))
    cfg = DetectorConfig(max_components=16, max_detections=4, ccl_iters=8)
    cpu = detect_tags_robust_staged(frames, cfg)
    gpu = detect_tags_robust_staged(frames.to(dev), cfg)
    assert torch.equal(gpu.ids.cpu(), cpu.ids)
    assert torch.equal(gpu.valid.cpu(), cpu.valid)
    v = cpu.valid
    assert (gpu.corners.cpu() - cpu.corners).abs()[v].max() <= 0.05
    assert cpu.ids[:, 0].tolist() == [11, 23, 24, 25, 3, -1]


def test_distorted_pipeline_on_card_without_sync(dev):
    """The pipeline with distortion coefficients, as tensors on the card,
    issues no synchronizing call; without a cloud B3 does not run."""
    from repas_tpu_torch.detect.render import example_frame
    from repas_tpu_torch.pipeline import process_frames

    rgb, depth, K = example_frame(360, 640)
    rgbs = torch.from_numpy(rgb[None]).to(dev)
    depths = torch.from_numpy(depth[None]).to(dev)
    Kd = torch.from_numpy(K).to(dev)
    dist = torch.tensor([-0.05, 0.01, 0.0, 0.0, 0.0], device=dev)
    process_frames(rgbs, depths, Kd, dist=dist)
    cpu = process_frames(rgbs.cpu(), depths.cpu(), K, dist=dist.cpu(),
                         with_pointcloud=False)
    before = _build.launches["pointcloud"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = process_frames(rgbs, depths, Kd, dist=dist,
                             with_pointcloud=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launches["pointcloud"] == before
    assert tuple(out.pointcloud.shape) == (1, 6, 0)
    assert torch.equal(out.detections.ids.cpu(), cpu.detections.ids)
    v = cpu.detections.valid
    assert (out.pose.t.cpu() - cpu.pose.t)[v].abs().max() <= 1e-4


def test_tracker_on_card_matches_cpu(dev):
    """The tracker on the card takes the modes, ids and poses of the
    tracker on the CPU (t within 0.05 mm) and reads the device once per
    track step."""
    import warnings

    from repas_tpu_torch.detect.render import render_tag_in_scene
    from repas_tpu_torch.pose.track import TagTracker, TrackerConfig

    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
    R = np.eye(3, dtype=np.float32)
    frames = [render_tag_in_scene(5, R, np.array([0.01 * i, 0, 0.5],
                                                 np.float32),
                                  K, 0.06, (480, 640), supersample=1)
              for i in range(4)]
    gpu = TagTracker(K, tag_size=0.06, config=TrackerConfig())
    cpu = TagTracker(K, tag_size=0.06, device="cpu")
    assert gpu.device.type == "cuda"
    for i, f in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                a = gpu.step(f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        b = cpu.step(f)
        assert (a.mode, a.ok, a.tag_id) == (b.mode, b.ok, b.tag_id)
        assert np.abs(a.t - b.t).max() <= 5e-5
        syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
        if i > 1:
            assert len(syncs) <= 1, [str(w.message) for w in syncs]


def test_front_end_on_card_matches_cpu(dev):
    """Alignment, NV12/YUYV and the tag bundle on the card against the
    port on the CPU: alignment differs on at most 1e-3 of the pixels (the
    floor of a projection within an ulp of an integer), YUV by at most one
    level on 0.05 % of the values, the bundle R within 0.01 degrees."""
    from repas_tpu_torch.kernels.align import align_depth_to_color
    from repas_tpu_torch.kernels.color import nv12_to_rgb, yuyv_to_rgb
    from repas_tpu_torch.pose.bundle import solve_tag_bundle

    rng = np.random.default_rng(5)
    depth = torch.from_numpy(rng.uniform(0.8, 1.2, (144, 160)).astype(
        np.float32))
    Kd = np.array([[126.0, 0, 80.1], [0, 126.1, 72.05], [0, 0, 1]],
                  np.float32)
    Kc = np.array([[228.1, 0, 157.2], [0, 227.9, 87.2], [0, 0, 1]],
                  np.float32)
    R, t = np.eye(3, dtype=np.float32), np.array([0.03, 0, 0], np.float32)
    a = align_depth_to_color(depth.to(dev), Kd, Kc, R, t, (180, 320)).cpu()
    b = align_depth_to_color(depth, Kd, Kc, R, t, (180, 320))
    assert (a != b).float().mean() <= 1e-3
    buf = torch.from_numpy(rng.integers(0, 256, (72, 64), dtype=np.uint8))
    for fn in (nv12_to_rgb, yuyv_to_rgb):
        d = (fn(buf.to(dev)).cpu().int() - fn(buf).int()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() <= 5e-4
    K = torch.tensor([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    centers = torch.tensor([[0.0, 0, 0], [0.12, 0, 0], [0, 0.1, 0]])
    h = 0.0303 / 2
    offs = torch.tensor([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]])
    cam = torch.cat([centers[:, None] + offs, centers[:, None]], 1) \
        + torch.tensor([0.02, -0.01, 0.7])
    px = cam[..., :2] / cam[..., 2:] * 600.0 + torch.tensor([320.0, 240.0])
    valid = torch.ones(3, dtype=torch.bool)
    Rg, tg, _ = solve_tag_bundle(px[:, :4].to(dev), px[:, 4].to(dev),
                                 valid.to(dev), centers.to(dev), 0.0303,
                                 K.to(dev))
    Rc, tc, _ = solve_tag_bundle(px[:, :4], px[:, 4], valid, centers,
                                 0.0303, K)
    assert (Rg.cpu() - Rc).abs().max() <= 2e-4
    assert (tg.cpu() - tc).abs().max() <= 1e-4


def _covariances(n, seed=0):
    """Covariances of 16-point neighbourhoods: planar, linear, isotropic,
    thin planar; then, where n > 2, one exactly isotropic and one
    zero."""
    g = torch.Generator().manual_seed(seed)
    scales = torch.tensor([[1, 1, 1e-3], [1, 1e-4, 1e-4], [1, 1, 1],
                           [1, 0.3, 0.01]])
    p = torch.randn(n, 16, 3, generator=g, dtype=torch.float64) \
        * scales[torch.arange(n) % 4][:, None, :]
    q, _ = torch.linalg.qr(torch.randn(n, 3, 3, generator=g,
                                       dtype=torch.float64))
    d = p @ q
    d = d - d.mean(dim=1, keepdim=True)
    A = (d.mT @ d).float()
    if n > 2:
        A[0] = 2.0 * torch.eye(3)
        A[1] = 0.0
    return A


# 128 matrices a block: one, a ragged block, one whole, one over; one
# 65,536-matrix chunk of the normals; over cuSOLVER's 32k
@pytest.mark.parametrize("n", [1, 37, 127, 128, 129, 65_536, 70_000])
def test_eig3_kernel_matches_plain(dev, n):
    A = _covariances(n).to(dev)
    before = _build.launches["eig3"]
    sweeps = torch.zeros(n, dtype=torch.int32, device=dev)
    w, V = eig3(A, sweeps=sweeps)
    assert _build.launches["eig3"] == before + 1
    # cuSOLVER's batched eigh takes under 32,768 matrices a call
    parts = [eig3_plain(A[i:i + 16384].double())
             for i in range(0, n, 16384)]
    wp = torch.cat([p[0] for p in parts])
    Vp = torch.cat([p[1] for p in parts])
    torch.cuda.synchronize()
    top = wp.abs().amax(dim=1)
    assert ((w.double() - wp).abs().amax(dim=1) <= 1e-5 * top + 1e-30).all()
    assert (w[:, 1:] >= w[:, :-1]).all()
    gap = (wp[:, 1] - wp[:, 0]) > 1e-6 * (wp.sum(dim=1) + 1e-30)
    a, b = V[:, :, 0].double(), Vp[:, :, 0]
    angle = torch.atan2(torch.linalg.cross(a, b).norm(dim=1),
                        (a * b).sum(dim=1).abs())
    assert (angle[gap] <= 1e-4).all()
    Ad, Vd = A.double(), V.double()
    res = (Ad @ Vd - Vd * w.double()[:, None, :]).norm(dim=1).amax(dim=1)
    assert (res <= 1e-5 * Ad.norm(dim=(1, 2)) + 1e-30).all()
    assert int(sweeps.max()) <= 8


def test_eig3_kernel_on_an_unaligned_view(dev):
    """A view 36 bytes into its storage takes the kernel's scalar
    staging: the same result as from an aligned copy."""
    A = _covariances(301).to(dev)
    w, V = eig3(A[1:])
    wa, Va = eig3(A[1:].clone())
    torch.cuda.synchronize()
    assert A[1:].data_ptr() % 16 != 0
    assert torch.equal(w, wa) and torch.equal(V, Va)


def _kabsch_triples(n, dev="cpu", seed=1):
    """Cross-covariances H (N,3,3) float32, on dev, of Gaussian point
    triples P, Q (a RANSAC draw's): every 5th P with a repeated pick,
    every 5th (from 2) collinear, every 97th (from 3) one point three
    times; where n > 4, H[4] = 0."""
    g = torch.Generator().manual_seed(seed)
    P = torch.randn(n, 3, 3, generator=g) * 0.1
    Q = torch.randn(n, 3, 3, generator=g) * 0.1
    P[1::5, 2] = P[1::5, 1]                               # a repeated pick
    P[2::5, 2] = P[2::5, 0] + 0.4 * (P[2::5, 1] - P[2::5, 0])  # collinear
    P[3::97] = P[3::97, :1]                               # one point
    P, Q = P.to(dev), Q.to(dev)
    H = (P - P.mean(dim=1, keepdim=True)).mT @ (Q - Q.mean(dim=1,
                                                           keepdim=True))
    if n > 4:
        H[4] = 0.0
    return H


# 32 matrices a warp's tile, 4 tiles a block: one matrix; one SQPnP
# problem's seeds (6) and a batch of 16's (16, 96); a tile less one,
# whole, one over; one RANSAC draw (8,192), and one over it as a view 36
# bytes into its storage (the scalar staging)
@pytest.mark.parametrize("n", [1, 6, 16, 31, 32, 33, 96, 8192, 8193])
def test_kabsch3_kernel_matches_plain(dev, n):
    if n == 8193:
        H = _kabsch_triples(n + 1, dev)[1:]
        H[4] = 0.0
        assert H.data_ptr() % 16 != 0
    else:
        H = _kabsch_triples(n, dev)
    before = _build.launches["kabsch3"]
    R = kabsch3(H)
    assert _build.launches["kabsch3"] == before + 1
    sweeps = torch.zeros(n, dtype=torch.int32, device=dev)
    Rs = kabsch3(H, sweeps=sweeps)
    Ra = kabsch3(H.clone())
    Rp = kabsch3_plain(H.double())
    s = torch.linalg.svdvals(H.double())
    torch.cuda.synchronize()
    assert torch.equal(Rs, R) and torch.equal(Ra, R)
    assert 0 <= int(sweeps.min()) and int(sweeps.max()) <= 10
    ok = s[:, 1] > 1e-6 * s[:, 0]
    if n == 8192:
        assert 4000 < int(ok.sum()) < 8192
    else:
        assert int(ok.sum()) >= n // 3
    assert float((R.double() - Rp).abs()[ok].max()) <= 1e-5
    assert float((torch.linalg.det(R.double()) - 1).abs().max()) <= 1e-5
    if n > 4:
        assert torch.equal(R[4], torch.eye(3, device=dev))


def test_eig3_and_kabsch3_reject_bad_inputs(dev):
    with pytest.raises(ValueError, match="eig3"):
        eig3(torch.zeros(4, 3, 3, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="kabsch3"):
        kabsch3(torch.zeros(4, 2, 3, device=dev))
    with pytest.raises(ValueError, match="sweeps"):
        eig3(torch.zeros(4, 3, 3, device=dev),
             sweeps=torch.zeros(3, dtype=torch.int32, device=dev))


def _symmetric9(n, seed=0):
    """(N,9,9) float64 symmetric matrices: Gram matrices of 12 random rows
    (rank 9), of 8 rows (a null vector, as an exact SQPnP Omega has), and
    Q diag Q^T with eigenvalues repeated in clusters; where n > 4, one
    zero matrix and one identity."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randn(n, 12, 9, generator=g, dtype=torch.float64)
    rows[1::3, 8:] = 0.0
    A = rows.mT @ rows
    q, _ = torch.linalg.qr(torch.randn(n, 9, 9, generator=g,
                                       dtype=torch.float64))
    lam = torch.tensor([1e-6, 1e-6, 1e-6, 0.5, 0.5, 2.0, 3.0, 3.0, 9.0],
                       dtype=torch.float64)
    A[2::3] = ((q * lam) @ q.mT)[2::3]
    if n > 4:
        A[3] = 0.0
        A[4] = torch.eye(9, dtype=torch.float64)
    return A


# three matrices a warp, four warps a block: the packing's remainders
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 16, 4096, 4097])
def test_eig9_kernel_matches_plain(dev, n, dtype):
    A = _symmetric9(n).to(dtype).to(dev)
    before = _build.launches["eig9"]
    sweeps = torch.zeros(n, dtype=torch.int32, device=dev)
    w, V = eig9(A, sweeps=sweeps)
    assert _build.launches["eig9"] == before + 1
    assert w.dtype == V.dtype == dtype
    wp, Vp = eig9_plain(A.double())
    torch.cuda.synchronize()
    f64 = dtype == torch.float64
    top = wp.abs().amax(dim=1, keepdim=True) + 1e-300
    assert ((w.double() - wp).abs() <= (1e-12 if f64 else 1e-5) * top).all()
    assert (w[:, 1:] >= w[:, :-1]).all()
    d = (wp[:, 1:] - wp[:, :-1]) / top
    inf = torch.full((n, 1), float("inf"), dtype=torch.float64, device=dev)
    gap = torch.minimum(torch.cat([inf, d], 1), torch.cat([d, inf], 1))
    dots = (V.double() * Vp).sum(dim=1).abs()
    assert (1 - dots[gap > 1e-4] <= (1e-10 if f64 else 1e-5)).all()
    Ad, Vd = A.double(), V.double()
    res = (Ad @ Vd - Vd * w.double()[:, None, :]).norm(dim=(1, 2))
    assert (res <= 1e-5 * Ad.norm(dim=(1, 2)) + 1e-30).all()
    eye = torch.eye(9, dtype=torch.float64, device=dev)
    assert float((Vd.mT @ Vd - eye).abs().max()) <= 1e-5
    assert int(sweeps.max()) <= 16


def test_eig9_result_does_not_depend_on_its_warp(dev):
    """Each matrix alone gives what it gives among the warp's others
    (they converge in different sweeps)."""
    A = _symmetric9(7).float().to(dev)
    w, V = eig9(A)
    for i in range(7):
        wi, Vi = eig9(A[i:i + 1])
        assert torch.equal(wi[0], w[i]) and torch.equal(Vi[0], V[i])


def test_eig9_rejects_bad_inputs(dev):
    with pytest.raises(ValueError, match="eig9"):
        eig9(torch.zeros(4, 9, 9, dtype=torch.float16, device=dev))
    with pytest.raises(ValueError, match="eig9"):
        eig9(torch.zeros(4, 3, 3, device=dev))
    with pytest.raises(ValueError, match="sweeps"):
        eig9(torch.zeros(4, 9, 9, device=dev),
             sweeps=torch.zeros(4, dtype=torch.int64, device=dev))


def _sqpnp_batch(n=16, points=12, seed=0):
    """n non-coplanar PnP problems: object points (n,P,3) within 0.1 m,
    pixels (n,P,2) under 0.3 px of noise, and K."""
    from repas_tpu_torch.kernels.project import project_points

    rng = np.random.default_rng(seed)
    K = torch.tensor([[748.9, 0, 639.87], [0, 748.35, 361.95], [0, 0, 1.0]])
    obj = torch.from_numpy(rng.uniform(-0.1, 0.1, (n, points, 3)).astype(
        np.float32))
    rv = torch.from_numpy(rng.normal(0, 0.3, (n, 3)).astype(np.float32))
    t = torch.from_numpy(np.stack([rng.uniform(-0.2, 0.2, n),
                                   rng.uniform(-0.15, 0.15, n),
                                   rng.uniform(0.4, 1.5, n)], 1).astype(
        np.float32))
    img = project_points(obj, rv, t, K) + torch.from_numpy(
        rng.normal(0, 0.3, (n, points, 2)).astype(np.float32))
    return obj, img, K


def _no_linalg_solvers(monkeypatch):
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"torch.linalg.{name} called on the card")
        return fn

    for name in ("solve", "svd", "eigh", "det"):
        monkeypatch.setattr(torch.linalg, name, refuse(name))


def test_sqpnp_on_card_without_linalg_and_compiled(dev, monkeypatch):
    from repas_tpu_torch.pose import pnp

    obj, img, K = _sqpnp_batch()
    Rc, tc, ec = pnp.solve_pnp_sqpnp(obj, img, K)
    args = (obj.to(dev), img.to(dev), K.to(dev))
    _no_linalg_solvers(monkeypatch)
    with torch.no_grad():
        R, t, e = pnp.solve_pnp_sqpnp(*args)
        pnp.solve_pnp_sqpnp_jit.clear()
        pnp.solve_pnp_sqpnp_jit(*args)                # capture + replay
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            Rj, tj, ej = pnp.solve_pnp_sqpnp_jit(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(Rj, R) and torch.equal(tj, t) and torch.equal(ej, e)
    # atan2(|sin|, cos): arccos of the trace turns float32 ulps into
    # hundredths of a degree
    Rr = R.cpu().double().mT @ Rc.double()
    w = torch.stack([Rr[..., 2, 1] - Rr[..., 1, 2], Rr[..., 0, 2]
                     - Rr[..., 2, 0], Rr[..., 1, 0] - Rr[..., 0, 1]], -1) / 2
    ang = torch.rad2deg(torch.atan2(w.norm(dim=-1), (Rr.diagonal(
        dim1=-2, dim2=-1).sum(-1) - 1) / 2))
    assert float(ang.max()) <= 0.01
    assert float((t.cpu() - tc).abs().max()) <= 1e-4
    assert float(e.max()) < 1.0


def test_tag_bundle_on_card_without_linalg(dev, monkeypatch):
    from repas_tpu_torch.pose.bundle import solve_tag_bundle_jit

    K = torch.tensor([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    centers = torch.tensor([[0.0, 0, 0], [0.12, 0, 0], [0, 0.1, 0]])
    h = 0.0303 / 2
    offs = torch.tensor([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]])
    cam = torch.cat([centers[:, None] + offs, centers[:, None]], 1) \
        + torch.tensor([0.02, -0.01, 0.7])
    px = cam[..., :2] / cam[..., 2:] * 600.0 + torch.tensor([320.0, 240.0])
    valid = torch.ones(3, dtype=torch.bool)
    Rc, tc, _ = solve_tag_bundle_jit(px[:, :4], px[:, 4], valid, centers,
                                     0.0303, K)
    _no_linalg_solvers(monkeypatch)
    with torch.no_grad():
        solve_tag_bundle_jit.clear()
        args = (px[:, :4].to(dev), px[:, 4].to(dev), valid.to(dev),
                centers.to(dev), 0.0303, K.to(dev))
        want = solve_tag_bundle_jit.fn(*args)
        solve_tag_bundle_jit(*args[:5], K.numpy())    # a numpy camera
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            Rg, tg, eg = solve_tag_bundle_jit(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(Rg, want[0]) and torch.equal(tg, want[1])
    assert (Rg.cpu() - Rc).abs().max() <= 2e-4
    assert (tg.cpu() - tc).abs().max() <= 1e-4
