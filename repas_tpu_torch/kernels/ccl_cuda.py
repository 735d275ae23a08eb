"""Kernel B1: connected-component labels on the GPU, and the launch plan
it shares with kernel B4's CCL.

Replaces the Pallas kernel ``repas_tpu/kernels/ccl_pallas.py::_ccl_kernel``
(entry ``connected_components_pallas``) with the band-resident kernel of
``csrc/ccl.cu``: each CTA holds the labels of a band of whole rows of one
image in shared memory for all ``iters`` rounds, so device memory sees
the mask read once and the labels written once. The bands of an image
synchronise three times per round, either as one thread-block cluster per
image (one launch per call) or, for images no cluster of 16 holds, in
cooperative launches over groups of images (one launch per group).
``plan_bands`` chooses the mode, the band height, the cluster size and
the groups from the card's limits. The result is the fixed-iteration
labelling of ``ccl.connected_components_plain``, bit for bit, or with
``converge`` its converged labelling: the bands of an image (of a launch,
in grid mode) agree after each round past ``iters`` whether any label
changed, and stop when none did, with no host read. Every call adds the
rounds each image ran, its images and one call to a counter on the card
(``counts`` reads it). See the source's header for what bounds it on the
H100.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repas_tpu_torch.kernels import _build

# Shared memory the runtime reserves per CTA on sm_90, beside the block's
# own: an SM holds k CTAs of s bytes when k * (s + 1 KB) fits the SM's
# 228 KB, which is the 227 KB a block may opt into plus that 1 KB.
SMEM_RESERVED = 1024
# cluster sizes tried; above 8 is non-portable on sm_90
CLUSTER_SIZES = tuple(range(1, 17))
# int arrays of W that a band publishes: its two column aggregates, its
# columns' first background rows and its two edge rows
AUX_ROWS = 5
# ints after them: the converging rounds' change flags (two, alternating
# by round), padded to 16 bytes
FLAG_INTS = 4
# the device counter's rows (``csrc/ccl.cu``): B1's calls and B4's
COUNTER_B1, COUNTER_B4 = 0, 1
# what a band costs per round beside its rows (three synchronisations,
# the carry folds, the lanes' shuffle scans), in rows of work
BAND_OVERHEAD_ROWS = 16


@dataclass(frozen=True)
class BandPlan:
    """How a (B,H,W) batch is cut into bands and launched."""
    mode: str        # "cluster" or "grid"
    cluster: int     # CTAs per cluster (= bands per image), 0 in grid mode
    band_rows: int   # rows per band; the last bands may hold fewer or none
    bands: int       # bands per image
    group: int       # images per launch
    launches: int
    smem: int        # dynamic shared memory per CTA, bytes


def row_pitch(w: int) -> int:
    """Ints per band row in shared memory (``ccl.cu::seg_len``): 32 lane
    segments of an odd length, padded with background past w."""
    return 32 * (-(-w // 32) | 1)


def band_smem(rows: int, w: int, cluster: bool) -> int:
    """Dynamic shared memory of one band CTA (``ccl.cu::band_smem``): its
    int32 labels at the padded row pitch and, in cluster mode, the
    published arrays and the change flags, rounded up to 16 bytes."""
    ints = rows * row_pitch(w) + (AUX_ROWS * w + FLAG_INTS if cluster
                                  else 0)
    return -(-4 * ints // 16) * 16


def _per_sm(smem: int, smem_block: int, blocks_per_sm: int) -> int:
    return min(blocks_per_sm,
               (smem_block + SMEM_RESERVED) // (smem + SMEM_RESERVED))


def plan_bands(B: int, h: int, w: int, *, smem_block: int, sm_count: int,
               blocks_per_sm: int, cluster_ok: bool = True,
               cluster_capacity=None) -> BandPlan:
    """Launch plan of the band CCL for a (B,h,w) batch on a card whose
    blocks may opt into `smem_block` bytes of shared memory, with
    `sm_count` SMs each holding at most `blocks_per_sm` band CTAs by
    registers and threads. `cluster_capacity(cluster, band_rows, per_sm)`
    gives the clusters the card holds at once (the card's
    cudaOccupancyMaxActiveClusters); without it, every SM's slots count.

    The cost of a plan is the rows one SM works through: rows per band
    plus ``BAND_OVERHEAD_ROWS``, times the CTAs that share an SM, summed
    over waves of clusters or over cooperative launches. Cluster mode (if
    `cluster_ok`) takes the cheapest cluster size of 1 to 16 whose bands
    fit a block, the smaller on a tie; grid mode, for images no cluster
    holds, the cheapest band height, then the fewer launches and the
    taller bands. Raises ValueError where a band of one row fits
    neither."""
    best = None
    if cluster_ok:
        for c in CLUSTER_SIZES:
            rows = -(-h // c)
            smem = band_smem(rows, w, True)
            if smem > smem_block:
                continue
            per_sm = _per_sm(smem, smem_block, blocks_per_sm)
            cap = (cluster_capacity(c, rows, per_sm) if cluster_capacity
                   else sm_count * per_sm // c)
            if cap < 1:
                continue
            # the cluster scheduler packs a cluster's CTAs onto as few
            # SMs as their shared memory allows
            cost = -(-B // cap) * (rows + BAND_OVERHEAD_ROWS) * per_sm
            if best is None or cost < best[0]:
                best = (cost, BandPlan("cluster", c, rows, c, B, 1, smem))
        if best is not None:
            return best[1]
    for rows in range(1, h + 1):
        smem = band_smem(rows, w, False)
        if smem > smem_block:
            break
        bands = -(-h // rows)
        if -(-h // bands) != rows:     # a shorter band height, same bands
            continue
        group = min(B, sm_count * _per_sm(smem, smem_block,
                                          blocks_per_sm) // bands)
        if group < 1:
            continue
        launches = -(-B // group)
        last = B - group * (launches - 1)
        cost = (rows + BAND_OVERHEAD_ROWS) * (
            (launches - 1) * -(-group * bands // sm_count)
            + -(-last * bands // sm_count))
        key = (cost, launches, -rows)
        if best is None or key < best[0]:
            best = (key, BandPlan("grid", 0, rows, bands, group, launches,
                                  smem))
    if best is None:
        raise ValueError(f"band CCL: a ({h},{w}) image fits no launch plan "
                         f"on a card with {smem_block} B of shared memory "
                         f"per block and {sm_count} SMs")
    return best[1]


@functools.lru_cache(maxsize=None)
def card_limits(index: int, w: int) -> dict:
    """The plan's limits as CUDA device `index` reports them for the band
    kernel of rows of width `w` (its register use depends on w)."""
    out = (ctypes.c_int * 4)()
    _build.check("repas_ccl_limits",
                 _build.library().repas_ccl_limits(w, index, out))
    return dict(smem_block=out[0], sm_count=out[1], blocks_per_sm=out[2])


@functools.lru_cache(maxsize=None)
def max_active_clusters(cluster: int, band_rows: int, w: int,
                        index: int) -> int:
    """cudaOccupancyMaxActiveClusters for clusters of `cluster` band CTAs
    of `band_rows` rows of width `w` on CUDA device `index`."""
    out = ctypes.c_int(0)
    _build.check("repas_ccl_max_clusters",
                 _build.library().repas_ccl_max_clusters(
                     cluster, band_rows, w, index, ctypes.byref(out)))
    return out.value


@functools.lru_cache(maxsize=None)
def _card_plan(B: int, h: int, w: int, index: int,
               cluster_ok: bool) -> BandPlan:
    return plan_bands(
        B, h, w, **card_limits(index, w), cluster_ok=cluster_ok,
        cluster_capacity=lambda c, rows, _: max_active_clusters(c, rows, w,
                                                                index))


def plan_for(mask: torch.Tensor, cluster_ok: bool = True) -> BandPlan:
    """The plan for a (B,H,W) mask on its CUDA device."""
    return _card_plan(*mask.shape, mask.device.index, cluster_ok)


def check_mask(name: str, mask: torch.Tensor, iters: int) -> None:
    if not mask.is_cuda:
        raise ValueError(f"{name}: mask must be a CUDA tensor")
    if mask.dtype != torch.bool or mask.ndim != 3:
        raise ValueError(f"{name}: needs a (B,H,W) bool mask, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if iters < 1:
        raise ValueError(f"{name}: iters={iters} < 1")
    B, h, w = mask.shape
    if h * w >= 2 ** 31 - 1 or B > 65535:
        raise ValueError(f"{name}: shape {tuple(mask.shape)} out of range "
                         "(H*W must fit int32, B at most 65535)")


def run_plan(mask: torch.Tensor, iters: int, plan: BandPlan,
             converge: bool = False, counter: int = COUNTER_B1
             ) -> torch.Tensor:
    """Launch the band CCL of ``csrc/ccl.cu`` on a checked CUDA mask,
    counted in row `counter` of the device counter."""
    B, h, w = mask.shape
    mask = mask.contiguous()
    out = torch.empty((B, h, w), dtype=torch.int32, device=mask.device)
    aux = None
    if plan.mode == "grid":
        aux = torch.empty(plan.group * plan.bands * AUX_ROWS * w + FLAG_INTS,
                          dtype=torch.int32, device=mask.device)
    _build.launch("repas_ccl", mask.device, mask.data_ptr(), out.data_ptr(),
                  aux.data_ptr() if aux is not None else None, B, h, w, iters,
                  int(converge), counter, plan.cluster, plan.band_rows,
                  plan.group)
    return out


def connected_components_cuda(mask: torch.Tensor, iters: int = 5,
                              converge: bool = False) -> torch.Tensor:
    """(B,H,W) bool mask on a CUDA device -> (B,H,W) int32 labels:
    `iters` rounds, or with `converge` at least `iters` and on to the
    fixed point."""
    check_mask("connected_components_cuda", mask, iters)
    out = run_plan(mask, iters, plan_for(mask), converge, COUNTER_B1)
    _build.launches["ccl"] += 1
    return out


def counts(device=None) -> dict:
    """The band CCL's device counter on a CUDA `device` (default the
    current one), read after a synchronisation: per kernel ("b1", "b4")
    the rounds its images ran, summed, its images and its calls, since
    the library was loaded. Launches inside replayed graphs count too.
    Zeros where no kernel was built in this process."""
    names = ("b1", "b4")
    if _build.loaded() is None:
        return {k: {"rounds": 0, "images": 0, "calls": 0} for k in names}
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(dev)
    out = (ctypes.c_ulonglong * 6)()
    _build.check("repas_ccl_counts",
                 _build.library().repas_ccl_counts(dev.index, out))
    return {k: {"rounds": out[3 * i], "images": out[3 * i + 1],
                "calls": out[3 * i + 2]} for i, k in enumerate(names)}
