"""The hand-written CUDA kernels (B1 CCL, B2 patch extraction, B3 point
cloud) against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where torch sees no CUDA device. On a machine
with a card: ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Tolerances: B1 and B2 exact; B3 rtol 1e-6 (same formula, same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.kernels import _build, ccl, ccl_cuda  # noqa: E402
from repas_tpu_torch.kernels import patch_extract, pointcloud  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,density,iters", [
    ((16, 360, 640), 0.55, 5),       # the main path's shape
    ((2, 720, 1280), 0.5, 5),        # the robust ladder's (kernel B4)
    ((3, 37, 53), 0.4, 1),           # odd sizes, partial warps
    ((1, 64, 33), 0.3, 4),
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


@pytest.mark.parametrize("shape,ah,aw,aligned", [
    ((16, 1536, 1280), 208, 384, True),
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
