"""The port's single-controller frame mesh (parallel/mesh.py) on a
4-shard CPU mesh (one process, the device "cpu" named four times),
mirroring tests/test_parallel.py: each helper against the JAX package's
on its own 4-device virtual CPU mesh, exactly, and the sharded frame
pipeline (process_frames at batch 4, 240x320) bit for bit against the
unsharded port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu import parallel as JP  # noqa: E402
from repas_tpu_torch.parallel import (batch_stats_psum, frames_mesh,  # noqa: E402
                                      fuse_views_allgather, shard_batch,
                                      sharded_frame_pipeline)
from test_torch_stream_scenes import one_torch_thread  # noqa: E402

N = 4


@pytest.fixture(scope="module")
def mesh():
    return frames_mesh(devices=["cpu"] * N)


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device virtual CPU mesh (tests/conftest.py)")
    return JP.frames_mesh(N)


def test_mesh_and_shards(mesh):
    assert mesh.size == N and all(d.type == "cpu" for d in mesh.devices)
    x = torch.arange(N * 6, dtype=torch.float32).reshape(N * 2, 3)
    shards = shard_batch(x, mesh)
    assert len(shards) == N and torch.equal(torch.cat(list(shards)), x)
    with pytest.raises(ValueError):
        shard_batch(x[:5], mesh)
    assert frames_mesh(2, devices=["cpu"] * N).size == 2


@pytest.mark.parametrize("n, want", [
    (None, ["cuda:0", "cuda:1"]), (1, ["cuda:0"]),
    (5, ["cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"])])
def test_frames_mesh_default_devices(monkeypatch, n, want):
    # the default mesh: each CUDA device once, or repeated in turn up to n
    # (no tensor is made, so two cards are only pretended)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in frames_mesh(n).devices] == want


def test_sharded_pipeline_matches_single(mesh, jmesh):
    x = np.arange(N * 6, dtype=np.float32).reshape(N, 6)
    f_j = lambda a: jnp.sin(a) * 2.0 + jnp.sum(a, axis=-1, keepdims=True)
    f_t = lambda a: torch.sin(a) * 2.0 + torch.sum(a, dim=-1, keepdim=True)
    with jmesh:
        ref = JP.sharded_frame_pipeline(f_j, jmesh)(
            JP.shard_batch(jnp.asarray(x), jmesh))
    xt = torch.from_numpy(x)
    out = sharded_frame_pipeline(f_t, mesh)(shard_batch(xt, mesh))
    assert torch.equal(out, f_t(xt))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    # a batched tensor argument is split too, a non-tensor goes whole
    g = sharded_frame_pipeline(lambda a, s: a * s, mesh)
    assert torch.equal(g(xt, 3.0), xt * 3.0)


def test_fuse_views_allgather(mesh, jmesh):
    pts = np.arange(N * 4 * 3, dtype=np.float32).reshape(N, 4, 3)
    valid = np.ones((N, 4), bool)
    valid[1, 2] = False
    with jmesh:
        fj, mj = JP.fuse_views_allgather(jmesh)(
            JP.shard_batch(jnp.asarray(pts), jmesh),
            JP.shard_batch(jnp.asarray(valid), jmesh))
    fused, masks = fuse_views_allgather(mesh)(
        shard_batch(torch.from_numpy(pts), mesh),
        shard_batch(torch.from_numpy(valid), mesh))
    assert len(fused) == len(masks) == N          # one copy per device
    for f, m in zip(fused, masks):
        assert f.shape == (N * 4, 3)
        assert np.array_equal(f.numpy(), np.asarray(fj))
        assert np.array_equal(m.numpy(), np.asarray(mj))


def test_batch_stats_psum(mesh, jmesh):
    v = np.arange(N, dtype=np.float32) * 1.5
    m = np.ones(N, bool)
    m[0] = False
    with jmesh:
        mean_j, cnt_j = JP.batch_stats_psum(jmesh)(
            JP.shard_batch(jnp.asarray(v), jmesh),
            JP.shard_batch(jnp.asarray(m), jmesh))
    mean, cnt = batch_stats_psum(mesh)(shard_batch(torch.from_numpy(v), mesh),
                                       shard_batch(torch.from_numpy(m), mesh))
    assert float(mean) == float(mean_j) and int(cnt) == int(cnt_j) == N - 1


def test_sharded_process_frames_bit_exact(mesh):
    """The sharded frame pipeline at batch 4, 240x320, default config,
    equal to the unsharded step in every output leaf, bit for bit."""
    from repas_tpu_torch.core.config import PipelineConfig
    from repas_tpu_torch.detect.render import example_frame
    from repas_tpu_torch.pipeline import process_frames

    rgbs, depths = [], []
    for i in range(N):
        rgb, depth, K = example_frame(240, 320, tag_id=(9, 16, 3, 9)[i],
                                      tag_frac=0.3 + 0.03 * i)
        rgbs.append(rgb)
        depths.append(depth)
    rgbs = torch.from_numpy(np.stack(rgbs))
    depths = torch.from_numpy(np.stack(depths))
    Kt = torch.from_numpy(K)
    cfg = PipelineConfig()
    fn = lambda r, d: process_frames(r, d, Kt, cfg)
    with one_torch_thread():
        single = fn(rgbs, depths)
        sharded = sharded_frame_pipeline(fn, mesh)(
            shard_batch(rgbs, mesh), shard_batch(depths, mesh))
    leaves_s = [*single.detections, *single.pose, single.pointcloud]
    leaves_m = [*sharded.detections, *sharded.pose, sharded.pointcloud]
    for a, b in zip(leaves_s, leaves_m):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.is_floating_point:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)
    ids = single.detections.ids
    assert (ids >= 0).sum() >= N - 1
