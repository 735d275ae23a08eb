"""Point-cloud filters: radius mask, voxel downsample, compaction,
statistical outlier removal.

Port of ``repas_tpu/cloud/filters.py``. Every filter works on a
fixed-shape (N,3) cloud with a validity mask: removing a point clears its
mask bit, it never reshapes.

``voxel_downsample`` (static `buckets`, the voxel a 0-d tensor),
``compact_masked`` (static `capacity`) and the outlier filter's step are
compiled on the card (``core.jit``). ``statistical_outlier_mask`` draws
its sample before its step, from a seeded ``torch.Generator``, which a
graph could not reseed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repas_tpu_torch.cloud.knn import _chunks, _scalar, _sqnorm
from repas_tpu_torch.core.jit import jit

# rows of the outlier filter's (rows, sample) distance block: 256 MB at
# the default sample of 2,048
SAMPLE_ROWS = 32768


def radius_mask(pts: torch.Tensor, mask: torch.Tensor,
                max_dist: float = 1.0, origin=None) -> torch.Tensor:
    """Keep points with ||p - origin|| < max_dist (origin: the camera)."""
    o = (torch.zeros(3, dtype=pts.dtype, device=pts.device) if origin is None
         else torch.as_tensor(origin, dtype=pts.dtype).to(pts.device))
    return mask & (_sqnorm(pts - o) < max_dist * max_dist)


@functools.partial(jit, static_argnames=("buckets",),
                   scalar_argnames=("voxel",))
def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor, voxel: float,
                     colors: torch.Tensor | None = None,
                     normals: torch.Tensor | None = None,
                     buckets: int | None = None):
    """Voxel-grid downsample by averaging per cell (Open3D
    voxel_down_sample semantics), over a hashed voxel map (unbounded
    extent). Buckets shared by two voxels keep only the first point's
    voxel.

    Returns (pts, colors, normals, valid), all sized like the input, with
    `valid` marking the one representative slot per occupied voxel (its
    first point), which carries that voxel's mean. The sums are float
    scatter-adds: on the CPU in index order, as the reference's; on the
    card in the atomics' order, so the means may differ by a few ulp."""
    n = pts.shape[0]
    dev = pts.device
    if buckets is None:
        buckets = max(1 << (2 * n - 1).bit_length(), 1024)  # ~4N pow2
    lo = torch.amin(torch.where(mask[:, None], pts, torch.inf), dim=0)
    ijk = torch.floor((pts - lo) / _scalar(voxel, dev)).to(torch.int32)
    # The reference multiplies in int32, wrapping; the low bits of the
    # int64 products are the same, and only they survive the mask.
    i64 = ijk.to(torch.int64)
    h = ((i64[:, 0] * 73856093) ^ (i64[:, 1] * 19349663)
         ^ (i64[:, 2] * 83492791)) & (buckets - 1)
    h = torch.where(mask, h, buckets)

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.full((buckets + 1,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, h, idx, "amin")
    rep = torch.clamp(first[h], 0, n - 1)
    # a point belongs to its bucket only if its voxel is the rep's voxel
    member = mask & torch.all(ijk == ijk[rep], dim=1)
    hm = torch.where(member, h, buckets)

    def bucket_sum(vals):
        out = torch.zeros((buckets + 1,) + vals.shape[1:],
                          dtype=torch.float32, device=dev)
        return out.index_add_(0, hm, vals)

    cnt = bucket_sum(torch.ones(n, dtype=torch.float32, device=dev))
    denom = torch.clamp(cnt[hm], min=1.0)[:, None]
    is_rep = member & (first[hm] == idx)

    def mean_of(vals):
        s = bucket_sum(torch.where(member[:, None], vals, 0.0))
        return s[hm] / denom

    out_pts = torch.where(is_rep[:, None], mean_of(pts), 0.0)
    out_cols = None
    if colors is not None:
        out_cols = torch.where(is_rep[:, None], mean_of(colors), 0.0)
    out_nrm = None
    if normals is not None:
        m = bucket_sum(torch.where(member[:, None], normals, 0.0))[hm]
        m = m / torch.clamp(torch.linalg.vector_norm(m, dim=1, keepdim=True),
                            min=1e-9)
        out_nrm = torch.where(is_rep[:, None], m, 0.0)
    return out_pts, out_cols, out_nrm, is_rep


@functools.partial(jit, static_argnames=("capacity",))
def compact_masked(pts: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Pack the valid rows into the first `capacity` slots, in their order
    (a stable sort on the mask; on the device, no host sync).

    Returns (pts (capacity,3), ok (capacity,), n_valid ()): n_valid >
    capacity means rows were dropped."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = order[:capacity]
    return pts[idx], mask[idx], torch.sum(mask.to(torch.int32))


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _choice(mask: torch.Tensor, num: int, replace: bool,
            gen: torch.Generator) -> torch.Tensor:
    """`num` indices drawn from the True entries of `mask` (uniformly;
    with or without replacement) by `gen`, a generator on the mask's
    device. Where the mask is all False the draw is uniform over every
    index (the callers then mask every result out). torch.multinomial
    raises for more than 2**24 points."""
    probs = torch.where(mask.any(), mask.to(torch.float32), 1.0)
    return torch.multinomial(probs, num, replacement=replace,
                             generator=gen)


def _sample_d2(pts: torch.Tensor, ref: torch.Tensor, ref_ok: torch.Tensor
               ) -> torch.Tensor:
    """(N,S) squared distances |p|^2 - 2 p.r + |r|^2 in the reference's
    order (inf where the sample point is invalid, clamped at 0), built in
    one (N,S) buffer. The reference's |p|^2 is XLA's fused
    fma(z, z, fma(y, y, x*x)); the plain sum here differs by an ulp."""
    d2 = (2.0 * pts) @ ref.T
    d2.neg_().add_(_sqnorm(pts)[:, None]).add_(_sqnorm(ref)[None, :])
    d2.clamp_(min=0.0)
    return d2.masked_fill_(~ref_ok[None, :], torch.inf)


@functools.partial(jit, static_argnames=("nb_neighbors", "rows"),
                   scalar_argnames=("std_ratio",))
def _outlier_mask_from_sample(pts: torch.Tensor, mask: torch.Tensor,
                              idx: torch.Tensor, nb_neighbors: int,
                              std_ratio: float, rows: int = SAMPLE_ROWS
                              ) -> torch.Tensor:
    """statistical_outlier_mask against the sample points `idx`, the
    neighbour distances `rows` points at a time (each row's depend on
    that row alone)."""
    ref = pts[idx]
    ref_ok = mask[idx]
    k = min(nb_neighbors + 1, idx.shape[0])            # +1: self may appear
    mean_d = torch.empty(pts.shape[0], dtype=pts.dtype, device=pts.device)
    for r0, r1 in _chunks(pts.shape[0], rows):
        d2 = _sample_d2(pts[r0:r1], ref, ref_ok)
        top = torch.topk(d2, k, dim=1, largest=False).values
        del d2
        dists = torch.sqrt(torch.clamp(top, min=0.0))  # (rows,k) ascending
        # jnp.mean in XLA: a sum in column order, times the f32 reciprocal
        s = dists[:, 1]
        for j in range(2, k):
            s = s + dists[:, j]
        mean_d[r0:r1] = s * float(np.float32(1.0)
                                  / np.float32(max(k - 1, 1)))
    n_ok = torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
    mu = torch.sum(torch.where(mask, mean_d, 0.0)) / n_ok
    resid = mean_d - mu
    var = torch.sum(torch.where(mask, resid * resid, 0.0)) / n_ok
    thresh = mu + std_ratio * torch.sqrt(var)
    return mask & (mean_d <= thresh)


def statistical_outlier_mask(pts: torch.Tensor, mask: torch.Tensor,
                             nb_neighbors: int = 20, std_ratio: float = 2.0,
                             sample: int = 2048, key: int | None = None
                             ) -> torch.Tensor:
    """Statistical outlier removal (Open3D remove_statistical_outlier):
    drop points whose mean distance to their `nb_neighbors` nearest
    neighbours exceeds mean + std_ratio * std. Neighbours are searched
    among `sample` points drawn without replacement from the valid ones
    (the (N, sample) distances SAMPLE_ROWS rows at a time), with the
    generator seeded by `key` (default 0)."""
    gen = _generator(pts.device, 0 if key is None else key)
    idx = _choice(mask, min(sample, pts.shape[0]), False, gen)
    return _outlier_mask_from_sample(pts, mask, idx, nb_neighbors, std_ratio)
