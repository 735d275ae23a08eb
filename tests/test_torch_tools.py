"""The port of the measurement tools (repas_tpu_torch.tools) and of their
kernels B5/B6 against the JAX tools (tools/*.py, loaded from their
files), on the CPU.

Tolerances, each with the value measured on the CPU against jax 0.9.0:
* profile_stages' stage prefixes, per frame, on two seeded 240x320 bench
  frames (the tool's ``_frames``): thresh, ccl, topk exact (integer
  sums); quad exact (quads are multiples of 0.5 below 2**23, so every
  summation order is exact); gray, pyramid, patches within 1e-6 relative
  (the same values summed in another order; measured 7.4e-8, 1.5e-7,
  3.2e-7); samp1 within 1e-5 relative (measured 1.8e-6: the sample
  positions carry XLA's FMA-contracted ulps, ROADMAP C); refine2 within
  0.1 px per corner coordinate of the frame's 48 candidates (measured
  3.72 px on frame 1, all of it on the copies of one dead candidate
  that fill its empty slots), and every candidate's refined corners
  within 0.1 px of the jitted reference ``_refine_edges`` on the same
  patches and quads (measured 0.068 px on those copies, where XLA's
  fused arithmetic moves a tied gradient peak of the quarter-pixel
  pass; 3.1e-5 px on every other candidate). Prefixes held: all but
  ``support`` (held through ``quad``, which is exact and consumes it)
  and ``refine1`` (held through ``refine2`` and the per-candidate
  check), which keeps the JAX compiles of this file near 20 s.
* B5, ``extract_windows_blk_plain``, against the tool's
  ``_extract_dma_batched`` run under ``pltpu.force_tpu_interpret_mode()``
  (f32 and bf16, starts that fit): exact. On a start whose window does
  not fit, the interpreted reference raises and the port raises
  ValueError.
* B6, ``extract_windows_exact_plain`` (the wrapper's CPU path), against
  the tool's own yardstick for it, the vmapped ``jax.lax.dynamic_slice``
  of section dmapatch2: exact, clamped starts included. The Pallas
  closure ``extract_dma`` is local to the tool's ``main()``, and in
  interpret mode it fails on the ``pl.ds`` indexing of a loaded value,
  so the yardstick stands in for it.
* micro_perf's gray and decimate variants on (2, 12, 16, 3) frames:
  f32 variants within 1e-6 relative (XLA contracts the weighted sums
  into FMAs), the bf16 matmul within one bf16 ulp (2**-8 relative: the
  products are summed in another order before the bf16 rounding).
* reconstruct_compare's ``sphere_cloud`` and ``vertex_err_mm``: exact.
"""
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repas_tpu.core.config import PipelineConfig as JConfig  # noqa: E402
from repas_tpu.detect.detector import _refine_edges as j_refine  # noqa: E402
from repas_tpu.kernels.image import (  # noqa: E402
    bilinear_sample_patch as j_sample)
from repas_tpu_torch.core.config import PipelineConfig  # noqa: E402
from repas_tpu_torch.kernels import patch_extract  # noqa: E402
from repas_tpu_torch.tools import micro_perf, profile_stages  # noqa: E402
from repas_tpu_torch.tools import reconstruct_compare  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def frames():
    rgbs, _, _ = profile_stages._frames(2, "cpu", 240, 320)
    return rgbs


@pytest.fixture(scope="module")
def jps():
    return _jax_tool("profile_stages")


@pytest.fixture(scope="module", autouse=True)
def jax_tool_departures(jps):
    """The JAX tool's detector stages with the port detector's two
    departures (``tests/jax_departures.py``): profile_stages mirrors the
    port's detector, converged labels and member-only support points."""
    import jax_departures

    with jax_departures.applied(jps):
        yield


@pytest.fixture(scope="module")
def jmp():
    return _jax_tool("micro_perf")


# stage -> (rtol, atol per frame)
STAGE_TOL = {"gray": (1e-6, 0.0), "thresh": (0.0, 0.0), "ccl": (0.0, 0.0),
             "topk": (0.0, 0.0), "quad": (0.0, 0.0),
             "pyramid": (1e-6, 0.0), "patches": (1e-6, 0.0),
             "samp1": (1e-5, 0.0), "refine2": (0.0, 0.1 * 48 * 8)}


@pytest.mark.parametrize("stage", list(STAGE_TOL))
def test_stage_prefix_matches_jax_tool(stage, frames, jps):
    cfg = JConfig().detector
    f = jax.jit(jax.vmap(lambda im: jps._stage_prefix(im, cfg, stage)))
    ref = np.asarray(f(jnp.asarray(frames.numpy()))).astype(np.float64)
    got = np.array([float(profile_stages._stage_prefix(
        frames[i:i + 1], PipelineConfig().detector, stage))
        for i in range(len(frames))])
    rtol, atol = STAGE_TOL[stage]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def test_refine_passes_match_reference_per_corner(frames, monkeypatch):
    """Both refine passes of the refine2 prefix, candidate by candidate,
    against the reference's _refine_edges jitted on the same inputs."""
    calls = []
    orig = profile_stages._refine_edges

    def spy(p, q, **kw):
        out = orig(p, q, **kw)
        calls.append((p, q, out, kw))
        return out

    monkeypatch.setattr(profile_stages, "_refine_edges", spy)
    profile_stages._stage_prefix(frames, PipelineConfig().detector,
                                 "refine2")
    assert [c[3] for c in calls] == [
        {"search": 4.0, "offset_step": 1.0},
        {"search": 1.0, "offset_step": 0.25}]
    for p, q, out, kw in calls:
        f = jax.jit(jax.vmap(lambda pp, qq, kw=kw: j_refine(
            pp, qq, sampler=j_sample, **kw)))
        ref = np.asarray(f(jnp.asarray(p.float().numpy()).astype(
            jnp.bfloat16), jnp.asarray(q.numpy())))
        assert np.abs(out.numpy() - ref).max() <= 0.1


def _blk_case(seed, dtype, hp, ph, tile_h):
    rng = np.random.default_rng(seed)
    pyr = rng.standard_normal((2, hp, 1280)).astype(np.float32)
    st = np.stack([rng.integers(0, (1280 - 384) // 128 + 1, (2, 5)),
                   rng.integers(0, (hp - ph) // tile_h + 1, (2, 5))],
                  axis=-1).astype(np.int32)
    # the last block that fits, on both axes
    st[0, 0] = [(1280 - 384) // 128, (hp - ph) // tile_h]
    return jnp.asarray(pyr).astype(dtype), st


@pytest.mark.parametrize("dtype,ph,tile_h", [(jnp.float32, 200, 8),
                                             (jnp.bfloat16, 208, 16)])
def test_b5_plain_matches_interpreted_pallas(dtype, ph, tile_h, jmp):
    pyr, st = _blk_case(0, dtype, 1512, ph, tile_h)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmp._extract_dma_batched(
            pyr, jnp.asarray(st), ph, 384, tile_h))
    tp = torch.from_numpy(np.array(pyr.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    got = patch_extract.extract_windows_blk(tp, torch.from_numpy(st), ph,
                                            384, tile_h)
    assert got.dtype == tp.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  ref.astype(np.float32))


@pytest.mark.parametrize("start", [(8, 0), (0, 165), (-1, 3), (2, -1)])
def test_b5_refuses_a_window_past_the_edge(start):
    """x block 8 is the JAX tool's own draw (x // 128 of x < 1088): 1024 +
    384 > 1280 columns; y block 165 of tile 8 gives 1320 + 200 > 1512
    rows."""
    pyr = torch.zeros((2, 1512, 1280))
    st = torch.zeros((2, 3, 2), dtype=torch.int32)
    st[1, 2] = torch.tensor(start)
    with pytest.raises(ValueError, match="does not fit"):
        patch_extract.extract_windows_blk(pyr, st, 200, 384, 8)


def test_b5_blk_origins_are_the_tile_starts():
    """The host check that B5's callers may run once before timing the
    launches: element origins [y_block * tile_h, x_block * 128], exact;
    the last block that fits is accepted, the next refused."""
    st = torch.tensor([[[0, 0], [7, 164], [3, 41]]], dtype=torch.int32)
    got = patch_extract.blk_origins((1, 1512, 1280), st, 200, 384, 8)
    assert got.tolist() == [[[0, 0], [1312, 896], [328, 384]]]
    with pytest.raises(ValueError, match="does not fit"):
        patch_extract.blk_origins((1, 1512, 1280), st + 1, 200, 384, 8)


def test_b5_interpreted_pallas_refuses_a_window_past_the_edge(jmp):
    pyr, st = _blk_case(0, jnp.float32, 1512, 200, 8)
    st[1, 2] = [8, 0]
    with pytest.raises(Exception, match="Out-of-bounds"):
        with pltpu.force_tpu_interpret_mode():
            np.asarray(jmp._extract_dma_batched(pyr, jnp.asarray(st), 200,
                                                384, 8))


def test_b5_jax_tool_draws_blocks_past_the_edge_and_micro_perf_clamps():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1280 - 192, (16, 48))
    assert (x // 128).max() == 8            # 1024 + 384 > 1280
    st = torch.tensor([[[8, 82], [3, 4]]], dtype=torch.int32)
    fit = micro_perf.fit_blocks(st, 1512, 1280, 208, 384, 16)
    assert fit.tolist() == [[[7, 81], [3, 4]]]


def test_b6_plain_matches_the_tools_dynamic_slice_yardstick():
    rng = np.random.default_rng(1)
    pyr = jnp.asarray(rng.standard_normal((2, 1520, 1280)).astype(
        np.float32)).astype(jnp.bfloat16)
    starts = np.stack([rng.integers(0, 1280 - 192, (2, 48)),
                       rng.integers(0, 1512 - 192, (2, 48))],
                      axis=-1).astype(np.int32)
    starts[1, :3] = [[1200, 1400], [1088, 0], [0, 1328]]   # clamped
    fx = jax.jit(lambda p, s: jax.vmap(lambda pp, ss: jax.vmap(
        lambda s1: jax.lax.dynamic_slice(pp, (s1[1], s1[0]), (192, 192)))(
        ss))(p, s))
    ref = np.asarray(fx(pyr, jnp.asarray(starts)).astype(jnp.float32))
    tp = torch.from_numpy(np.array(pyr.astype(jnp.float32))).to(
        torch.bfloat16)
    got = patch_extract.extract_windows_exact(
        tp, torch.from_numpy(starts), 192, 192)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), ref)


def _imgs():
    rng = np.random.default_rng(2)
    return rng.integers(0, 256, (2, 12, 16, 3)).astype(np.uint8)


@pytest.mark.parametrize("name,rtol", [
    ("gray_naive", 1e-6), ("gray_bitcast", 1e-6), ("gray_matmul", 1e-6),
    ("gray_matmul_bf16", 2.0 ** -8), ("gray_conv", 1e-6),
    ("gray_weighted_pairsum", 1e-6), ("gray_u32pad", 1e-6)])
def test_gray_variants_match_jax_tool(name, rtol, jmp, monkeypatch):
    imgs = _imgs()
    # the JAX tool tiles its per-byte weights for 1280 columns
    monkeypatch.setattr(jmp, "_WREP", np.tile(jmp.LUM, imgs.shape[2]))
    ref = np.asarray(jax.jit(jax.vmap(getattr(jmp, name)))(
        jnp.asarray(imgs)))
    got = getattr(micro_perf, name)(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=0.0)


DECIMATORS = ["dec_reshape", "dec_strided", "dec_rowcol",
              "dec_reduce_window", "dec_conv"]


@pytest.mark.parametrize("name", DECIMATORS)
def test_decimate_variants_match_jax_tool(name, jmp, monkeypatch):
    """The JAX tool defines its decimators inside main(): capture them by
    running its decim section with a stub timer on a tiny batch."""
    from repas_tpu.kernels.image import rgb_to_gray
    found = {}

    def fake_timeit(label, f, *args, ref=None):
        found[label] = f
        return 0.0

    monkeypatch.setattr(jmp, "timeit", fake_timeit)
    monkeypatch.setattr(jmp, "BATCH", 2)
    monkeypatch.setattr(jmp, "H", 12)
    monkeypatch.setattr(jmp, "W", 16)
    monkeypatch.setattr(jmp.sys, "argv", ["micro_perf", "decim"])
    jmp.main()
    labels = ["reshape-mean(current)", "strided 4-add", "row then col",
              "reduce_window", "conv 2x2 s2"]
    assert sorted(found) == sorted(labels)
    gray = np.asarray(jax.vmap(rgb_to_gray)(jnp.asarray(_imgs())))
    # found[...] jits sum(vmap(dec(rgb_to_gray))); recover the decimator
    # itself from its closure to compare whole images, not sums
    dec = found[labels[DECIMATORS.index(name)]].__wrapped__.__defaults__[0]
    ref = np.asarray(jax.jit(jax.vmap(dec))(jnp.asarray(gray)))
    got = getattr(micro_perf, name)(torch.from_numpy(gray))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0.0)


def test_sphere_cloud_and_vertex_error_match_jax_tool():
    jrc = _jax_tool("reconstruct_compare")
    a, b = reconstruct_compare.sphere_cloud(1000), jrc.sphere_cloud(1000)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.normals, b.normals)
    from repas_tpu_torch.io.ply import TriangleMesh
    mesh = TriangleMesh(vertices=a.points * 1.01,
                        triangles=np.zeros((1, 3), np.int64))
    assert reconstruct_compare.vertex_err_mm(mesh) == jrc.vertex_err_mm(mesh)


@pytest.mark.parametrize("tool", ["profile_stages", "micro_perf",
                                  "reconstruct_compare"])
def test_tool_defaults_to_cuda_and_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repas_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
