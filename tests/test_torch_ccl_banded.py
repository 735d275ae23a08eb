"""The band decomposition of the CCL kernel (``csrc/ccl.cu``) and its
launch plan, on the CPU.

``_banded_ccl`` below is a pure-torch model of what the band-resident
kernel computes: each band of whole rows runs a forward min down its
columns and publishes per-column aggregates (its bottom and top runs'
minima, whether it held a break); then every foreground pixel takes its
run's min up the band, with the carries folded from the other bands back
to the nearest break where the run reaches the band's edge; the
8-neighbour stencil runs as a vertical 3-min per band with the
neighbouring bands' edge rows, then a horizontal 3-min. It is held bit-exact
to ``connected_components_plain`` and to the JAX package's
``_connected_components_xla``, at band heights that do and do not divide
H and with empty trailing bands, converged or not. With ``converge`` it
also stops as the kernel does: after a round whose vertical minima
repeat the round before's, at least ``iters`` and two rounds in; held to
the plain converged labels, and to stopping one or two rounds after the
fixed-round labels first converge. Tolerance: exact (integer labels from
min, compares and selects).

The plan is checked at the H100's limits (232,448 B of shared memory a
block may opt into, 132 SMs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels.ccl import _connected_components_xla  # noqa: E402
from repas_tpu_torch.kernels import ccl, ccl_cuda, ccl_tiled  # noqa: E402
from repas_tpu_torch.kernels.ccl_cuda import (  # noqa: E402
    SMEM_RESERVED, band_smem, plan_bands)

# an H100's limits for the band kernel: shared memory a block may opt
# into, SMs, band CTAs an SM holds by registers (2 for rows of 640, 1 for
# rows of 1280, whose kernel keeps 41 labels a lane in registers)
H100_LIMITS = dict(smem_block=232448, sm_count=132, blocks_per_sm=2)


def _spans(h, band_rows, bands):
    return [(k * band_rows, max(k * band_rows, min((k + 1) * band_rows, h)))
            for k in range(bands)]


def _fold(aggs, order, sent):
    """Carry from the (value, break) aggregates of the bands in `order`:
    their min back to the nearest one with a break, inclusive."""
    v0 = aggs[0][0]
    carry = torch.full_like(v0, sent)
    done = torch.zeros(v0.shape, dtype=torch.bool)
    for j in order:
        v, b = aggs[j]
        carry = torch.where(done, carry, torch.minimum(carry, v))
        done = done | b
    return carry


def _band_cols(lab, mask, band_rows, bands):
    """The column scans, band by band: a forward running min down each
    band, publishing each column's bottom-run and top-run minima (with
    whether the band's column held background); then, up each band, every
    foreground pixel takes its run's min, with the carry folded from the
    bands below if the run reaches the band's bottom and from the bands
    above if it reaches the band's top."""
    B, h, w = lab.shape
    sent = h * w
    lab = lab.clone()
    spans = _spans(h, band_rows, bands)
    down, up, first_bg = [], [], []
    for y0, y1 in spans:
        run = torch.full((B, w), sent, dtype=lab.dtype)
        top = run.clone()
        open_ = torch.ones((B, w), dtype=torch.bool)
        first = torch.full((B, w), y1, dtype=torch.int64)
        for y in range(y0, y1):
            m = mask[:, y]
            run = torch.where(m, torch.minimum(run, lab[:, y]), sent)
            lab[:, y] = run
            first = torch.where(open_ & ~m, y, first)
            open_ &= m
            top = torch.where(open_, run, top)
        brk = first < y1
        down.append((run, brk))
        up.append((top, brk))
        first_bg.append(first)
    for k, (y0, y1) in enumerate(spans):
        above = _fold(down, range(k - 1, -1, -1), sent)
        run = _fold(up, range(k + 1, bands), sent)
        for y in range(y1 - 1, y0 - 1, -1):
            run = torch.where(mask[:, y], torch.minimum(run, lab[:, y]),
                              sent)
            lab[:, y] = torch.where(y < first_bg[k],
                                    torch.minimum(run, above), run)
    return lab


def _banded_ccl(mask, iters, band_rows, bands=None, converge=False):
    """The band kernel's arithmetic on (B,H,W) masks; `bands` may exceed
    ceil(H / band_rows), leaving empty bands at the bottom. The stencil
    runs as the kernel runs it: the vertical 3-min per band with the
    neighbouring bands' edge rows, then the horizontal 3-min. With
    `converge`, returns (labels, rounds run), stopping as the kernel's
    launch does."""
    B, h, w = mask.shape
    bands = bands or -(-h // band_rows)
    sent = h * w
    idx = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
    lab = torch.where(mask, idx, sent)
    spans = _spans(h, band_rows, bands)
    edge = torch.full((B, 1, w), sent, dtype=lab.dtype)
    rounds, last = 0, None
    while rounds < iters or converge:
        for reverse in (False, True):           # rows lie whole in a band
            lab = torch.where(mask, ccl._seg_min_scan(lab, ~mask, 2, reverse,
                                                      sent), sent)
        lab = _band_cols(lab, mask, band_rows, bands)
        tops = [lab[:, y0:y0 + 1] if y1 > y0 else edge for y0, y1 in spans]
        bots = [lab[:, y1 - 1:y1] if y1 > y0 else edge for y0, y1 in spans]
        vmin = lab.clone()
        for k, (y0, y1) in enumerate(spans):
            if y1 == y0:
                continue
            above = bots[k - 1] if k > 0 else edge
            below = tops[k + 1] if k + 1 < bands else edge
            ext = torch.cat([above, lab[:, y0:y1], below], dim=1)
            vmin[:, y0:y1] = torch.minimum(torch.minimum(ext[:, :-2],
                                                         ext[:, 1:-1]),
                                           ext[:, 2:])
        p = torch.nn.functional.pad(vmin, (1, 1), value=sent)
        hmin = torch.minimum(torch.minimum(p[..., :-2], p[..., 1:-1]),
                             p[..., 2:])
        lab = torch.where(mask, hmin, sent)
        rounds += 1
        if converge:
            # the vertical minima of the foreground repeat the last round's
            fg = torch.where(mask, vmin, 0)
            same = last is not None and torch.equal(fg, last)
            last = fg
            if same and rounds >= max(iters, 2):
                return lab, rounds
    return lab


def _xla(masks, iters):
    return np.stack([np.asarray(_connected_components_xla(
        jnp.asarray(m), iters=iters)) for m in masks])


def _spiral(n=33):
    m = np.zeros((1, n, n), bool)
    lo, hi = 1, n - 2
    while lo < hi:
        m[0, lo, lo:hi + 1] = True
        m[0, lo:hi + 1, hi] = True
        m[0, hi, lo:hi + 1] = True
        m[0, lo + 2:hi + 1, lo] = True
        lo, hi = lo + 2, hi - 2
    return m


@pytest.mark.parametrize("shape,density,iters,band_rows,bands", [
    ((2, 37, 70), 0.45, 5, 8, None),    # 8 does not divide 37
    ((2, 37, 70), 0.3, 3, 1, None),     # one row per band
    ((2, 37, 70), 0.6, 5, 37, None),    # one band
    ((2, 40, 33), 0.4, 4, 10, None),    # 10 divides 40
    ((1, 24, 48), 0.5, 2, 5, 8),        # three empty bands at the bottom
    ((2, 64, 96), 0.0, 2, 16, None),    # all foreground: carries cross bands
])
def test_band_model_matches_plain_and_xla(shape, density, iters, band_rows,
                                          bands):
    masks = np.random.default_rng(band_rows).random(shape) >= density
    got = _banded_ccl(torch.from_numpy(masks), iters, band_rows, bands)
    assert torch.equal(got, ccl.connected_components_plain(
        torch.from_numpy(masks), iters))
    np.testing.assert_array_equal(got.numpy(), _xla(masks, iters))


@pytest.mark.parametrize("band_rows", [4, 7, 33])
def test_band_model_keeps_unconverged_spiral(band_rows):
    """One round does not converge the spiral; the bands must keep the
    reference's partial labels."""
    m = _spiral()
    got = _banded_ccl(torch.from_numpy(m), 1, band_rows)[0].numpy()
    np.testing.assert_array_equal(got, _xla(m, 1)[0])
    assert len(np.unique(got[m[0]])) > 1


@pytest.mark.parametrize("mask,iters,band_rows", [
    (_spiral(), 1, 4),
    (_spiral(), 5, 7),
    (_spiral(25), 30, 33),                  # converged before `iters`
    (np.random.default_rng(3).random((2, 37, 70)) >= 0.4, 1, 8),
    (np.zeros((1, 24, 48), bool), 1, 5),    # nothing to label
])
def test_band_model_stops_after_the_labels_converge(mask, iters, band_rows):
    m = torch.from_numpy(mask)
    got, rounds = _banded_ccl(m, iters, band_rows, converge=True)
    conv = ccl.connected_components_plain(m, iters, converge=True)
    assert torch.equal(got, conv)
    first = 0
    while not torch.equal(ccl.connected_components_plain(m, first)
                          if first else ccl.initial_labels(m), conv):
        first += 1
    assert rounds == max(iters, 2) or first + 1 <= rounds <= first + 2, \
        (rounds, first)


# cudaOccupancyMaxActiveClusters of the band kernel's clusters on an H100
# 80GB HBM3, by CTAs per SM and cluster size, as `ccl_timing.py --plans`
# prints it: the GPCs, not the SM count, bound how many clusters run at
# once
H100_CLUSTERS = {
    1: {2: 66, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9},
    2: {3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30, 9: 23, 10: 21, 11: 16,
        12: 16, 13: 14, 14: 14, 15: 14, 16: 14},
}


def _h100_capacity(cluster, band_rows, per_sm):
    return H100_CLUSTERS[per_sm].get(cluster, 132 * per_sm // cluster)


@pytest.mark.parametrize("shape,mode,cluster,band_rows,bands,group,launches", [
    ((16, 360, 640), "cluster", 6, 60, 6, 16, 1),    # the main path: 16
                                                     # clusters of 6 fit
    ((8, 360, 640), "cluster", 9, 40, 9, 8, 1),      # ladder stage A
    ((16, 256, 256), "cluster", 12, 22, 12, 16, 1),  # stage B ROIs
    ((1, 360, 640), "cluster", 9, 40, 9, 1, 1),      # tracker registration
    ((1, 256, 256), "cluster", 16, 16, 16, 1, 1),    # tracker ROI step
    ((1, 724, 724), "cluster", 16, 46, 16, 1, 1),    # needs a cluster over 8
    ((1, 512, 1024), "cluster", 16, 32, 16, 1, 1),   # MAX_VMEM_PIXELS
    ((2, 720, 1280), "grid", 0, 11, 66, 2, 1),       # over any cluster
    ((12, 720, 1280), "grid", 0, 33, 22, 6, 2),      # two groups
])
def test_plan_at_h100_limits(shape, mode, cluster, band_rows, bands, group,
                             launches):
    plan = plan_bands(*shape, **H100_LIMITS,
                      cluster_capacity=_h100_capacity)
    assert (plan.mode, plan.cluster, plan.band_rows, plan.bands, plan.group,
            plan.launches) == (mode, cluster, band_rows, bands, group,
                               launches)
    _check_plan(plan, shape)


def test_plan_without_capacity_counts_every_sm_slot():
    """Without the card's cluster capacity the plan assumes every SM's
    slots hold clusters: 16 clusters of 8 then fit the H100's 132 SMs."""
    plan = plan_bands(16, 360, 640, **H100_LIMITS)
    assert (plan.mode, plan.cluster, plan.band_rows) == ("cluster", 8, 45)


def test_tiled_plan_is_always_grid():
    """B4's CCL takes grid mode even where a cluster would fit: one band
    CTA of 22 rows on each of the 132 SMs."""
    plan = plan_bands(4, 720, 1280, **H100_LIMITS, cluster_ok=False)
    assert (plan.mode, plan.band_rows, plan.bands, plan.group,
            plan.launches) == ("grid", 22, 33, 4, 1)
    _check_plan(plan, (4, 720, 1280))
    small = plan_bands(3, 40, 33, **H100_LIMITS, cluster_ok=False)
    assert (small.mode, small.band_rows, small.bands) == ("grid", 1, 40)


def test_grid_plan_with_one_block_per_sm():
    limits = dict(H100_LIMITS, blocks_per_sm=1)
    plan = plan_bands(4, 720, 1280, **limits, cluster_ok=False)
    assert (plan.band_rows, plan.bands, plan.group, plan.launches) == (
        22, 33, 4, 1)
    _check_plan(plan, (4, 720, 1280), blocks_per_sm=1)
    plan = plan_bands(12, 720, 1280, **limits, cluster_ok=False)
    assert (plan.band_rows, plan.bands, plan.group, plan.launches) == (
        33, 22, 6, 2)
    _check_plan(plan, (12, 720, 1280), blocks_per_sm=1)


def test_plan_raises_where_no_mode_fits():
    with pytest.raises(ValueError, match="fits no launch plan"):
        plan_bands(1, 2, 200000, **H100_LIMITS)


def _check_plan(plan, shape, blocks_per_sm=2):
    B, h, w = shape
    assert plan.smem == band_smem(plan.band_rows, w, plan.mode == "cluster")
    assert plan.smem <= H100_LIMITS["smem_block"]
    assert plan.band_rows * plan.bands >= h
    assert plan.group * (plan.launches - 1) < B <= plan.group * plan.launches
    if plan.mode == "grid":
        # every band CTA of a launch resident at once, no band empty
        assert (plan.bands - 1) * plan.band_rows < h
        per_sm = min(blocks_per_sm, (H100_LIMITS["smem_block"]
                                     + SMEM_RESERVED)
                     // (plan.smem + SMEM_RESERVED))
        assert plan.bands * plan.group <= per_sm * H100_LIMITS["sm_count"]
    else:
        assert plan.cluster == plan.bands <= 16


@pytest.mark.parametrize("limits,shape", [
    (dict(smem_block=8192, sm_count=8, blocks_per_sm=2), (2, 37, 70)),
    (dict(smem_block=4096, sm_count=64, blocks_per_sm=4), (1, 53, 41)),
])
def test_model_at_plans_of_small_cards(limits, shape):
    """The plan on cards small enough to cut these shapes into many bands
    (grid mode for B4's CCL, cluster mode where it fits), and the model at
    the plan's bands: the labels stay the reference's."""
    masks = np.random.default_rng(11).random(shape) > 0.5
    ref = _xla(masks, 4)
    for cluster_ok in (True, False):
        plan = plan_bands(*shape, **limits, cluster_ok=cluster_ok)
        assert plan.bands > 1
        got = _banded_ccl(torch.from_numpy(masks), 4, plan.band_rows,
                          plan.bands)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU mask never reaches a kernel wrapper's launch: it raises before
    the kernel library is built."""
    mask = torch.zeros((1, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccl_cuda.connected_components_cuda(mask)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccl_tiled.connected_components_tiled_cuda(mask)
