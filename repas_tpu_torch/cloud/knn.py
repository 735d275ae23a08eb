"""Grid-hash nearest neighbours on the device.

Port of ``repas_tpu/cloud/knn.py``. Fixed-capacity, masked formulation:
points are binned into a dense 3-D voxel grid over their AABB (up to
`slots` points per cell, one per scatter-max pass), and queries gather
the 3x3x3 neighbourhood's candidates. Every shape is static; queries run
in chunks of `chunk` rows so the (chunk, 27*slots, 3) gather stays
bounded at any query count. Each row's result depends on that row alone,
so results do not depend on the chunk.

``grid_hash_build``, ``grid_hash_query`` and ``grid_hash_query_knn`` are
compiled steps on the card (``core.jit``, as the reference jits them):
`dims`, `slots`, `k` and `chunk` static, the cell size a 0-d tensor. On
the card ``grid_hash_query`` is one launch of kernel K4
(``kernels/grid_query.py``), bit-equal to its chunked plain version.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repas_tpu_torch.core.consts import const
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.kernels.grid_query import grid_query

# the 3x3x3 neighbourhood offsets, dx-major, so the candidate column order
# (27 offsets x slots) is the reference's
_OFFSETS = np.array([[dx, dy, dz]
                     for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], dtype=np.int32)
_OFFSETS_T = tuple(map(tuple, _OFFSETS.tolist()))


class GridHash(NamedTuple):
    cell_of: torch.Tensor    # (slots, n_cells) int32 point index or -1
    origin: torch.Tensor     # (3,)
    cell: torch.Tensor       # () cell size


def _scalar(x, device) -> torch.Tensor:
    """A 0-dim float32 tensor on `device`. A Python float is filled on the
    device (no blocking host copy); dividing by a tensor, unlike by a
    Python scalar, is a true division on the card as on the CPU."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def _sqnorm(v: torch.Tensor) -> torch.Tensor:
    """Squared length over a last dim of 3, summed in order."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return (x * x + y * y) + z * z


def _cell_ijk(pts, origin, cell, dims) -> torch.Tensor:
    """(N,3) int64 cell coordinates, clamped to the grid. Clamped before
    the integer conversion, which saturates as XLA's does."""
    hi = const(tuple(float(d - 1) for d in dims), torch.float32, pts.device)
    f = torch.floor((pts - origin) / cell)
    return torch.minimum(torch.clamp(f, min=0.0), hi).to(torch.int64)


def _cell_ids(pts, origin, cell, dims) -> torch.Tensor:
    ijk = _cell_ijk(pts, origin, cell, dims)
    nx, ny, nz = dims
    return (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]


def grid_hash_build(pts: torch.Tensor, mask: torch.Tensor, origin, cell,
                    dims: tuple, slots: int = 4) -> GridHash:
    """Bin masked points into the grid. Up to `slots` points kept per cell
    (the highest indices, one per pass; the others are dropped, as the
    reference does). `origin` (3,) may lie on the host."""
    origin = torch.as_tensor(origin, dtype=torch.float32).to(pts.device)
    return _grid_hash_build(pts, mask, origin, cell, dims, slots)


@functools.partial(jit, static_argnames=("dims", "slots"),
                   scalar_argnames=("cell",))
def _grid_hash_build(pts, mask, origin, cell, dims, slots) -> GridHash:
    dev = pts.device
    cell = _scalar(cell, dev)
    n_cells = dims[0] * dims[1] * dims[2]
    cid = _cell_ids(pts, origin, cell, dims)
    cid = torch.where(mask, cid, n_cells)          # park invalid in overflow
    idx = torch.arange(pts.shape[0], dtype=torch.int32, device=dev)

    taken = []
    used = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
    for _ in range(slots):
        # scatter-max picks one untaken point per cell deterministically
        cand = torch.where(used, -1, idx)
        buf = torch.full((n_cells + 1,), -1, dtype=torch.int32, device=dev)
        buf.scatter_reduce_(0, cid, cand, "amax")
        taken.append(buf[:n_cells])
        used = used | (buf[cid] == idx)
    return GridHash(cell_of=torch.stack(taken), origin=origin, cell=cell)


def _candidate_indices(gh: GridHash, qpts: torch.Tensor, dims: tuple
                       ) -> torch.Tensor:
    """(Q, 27*slots) int32 candidate target indices (-1 = empty), 27
    offsets x slots. Query cells clamp like the targets' did, so queries
    beyond the extent search the boundary cells."""
    nx, ny, nz = dims
    dev = qpts.device
    ijk = _cell_ijk(qpts, gh.origin, gh.cell, dims)
    q = ijk[:, None, :] + const(_OFFSETS_T, torch.int64, dev)[None]
    inb = torch.all((q >= 0) & (q < const(tuple(dims), torch.int64, dev)),
                    dim=-1)                                   # (Q,27)
    qc = (q[..., 0] * ny + q[..., 1]) * nz + q[..., 2]
    qc = torch.where(inb, qc, 0)
    pi = gh.cell_of[:, qc]                                    # (S,Q,27)
    pi = torch.where(inb[None] & (pi >= 0), pi, -1)
    return pi.permute(1, 2, 0).reshape(qpts.shape[0], -1)


def _candidate_d2(gh, target_pts, qpts, dims):
    """Candidates (C, 27*slots) and their squared distances (inf where
    empty)."""
    cand = _candidate_indices(gh, qpts, dims)
    diff = target_pts[torch.clamp(cand, min=0)] - qpts[:, None, :]
    d2 = torch.where(cand >= 0, _sqnorm(diff), torch.inf)
    return cand, d2


def _chunks(n: int, chunk: int):
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


@functools.partial(jit, static_argnames=("dims", "chunk"))
def grid_hash_query(gh: GridHash, target_pts: torch.Tensor,
                    query_pts: torch.Tensor, query_mask: torch.Tensor,
                    dims: tuple, chunk: int = 16384):
    """1-NN search over the 27 neighbouring cells' slots.

    Returns (nn_idx (Q,) int32 [-1 if none], nn_dist (Q,) f32 [inf]).
    Ties go to the first candidate column (torch.argmin, as jnp.argmin).
    On the card one launch of kernel K4 (`chunk` unused), bit-equal to
    the plain version, which runs on the CPU."""
    if query_pts.is_cuda:
        return grid_query(gh.cell_of, gh.origin, gh.cell,
                          target_pts.contiguous(), query_pts.contiguous(),
                          query_mask.contiguous(), dims)
    return grid_hash_query_plain(gh, target_pts, query_pts, query_mask,
                                 dims, chunk)


def grid_hash_query_plain(gh: GridHash, target_pts: torch.Tensor,
                          query_pts: torch.Tensor, query_mask: torch.Tensor,
                          dims: tuple, chunk: int = 16384):
    """Plain K4: grid_hash_query in chunks of `chunk` rows, each gathering
    its (rows, 27*slots) candidates."""
    nq = query_pts.shape[0]
    idx = torch.empty(nq, dtype=torch.int32, device=query_pts.device)
    dist = torch.empty(nq, dtype=torch.float32, device=query_pts.device)
    for s, e in _chunks(nq, chunk):
        cand, d2 = _candidate_d2(gh, target_pts, query_pts[s:e], dims)
        j = torch.argmin(d2, dim=1, keepdim=True)
        dmin = torch.gather(d2, 1, j)[:, 0]
        imin = torch.gather(cand, 1, j)[:, 0]
        ok = query_mask[s:e] & (imin >= 0)
        idx[s:e] = torch.where(ok, imin, -1)
        dist[s:e] = torch.where(ok, torch.sqrt(dmin), torch.inf)
    return idx, dist


def _slots_together(gh: GridHash) -> GridHash:
    """gh with the same cell_of, held with a cell's slots side by side
    in memory (a (cells, slots) copy seen transposed), so K4 reads a
    cell's slots in one or two sectors (at ICP's shapes 1.06 and 0.93 ms
    a level against 2.93 and 2.09 on the table as built, H100)."""
    return gh._replace(cell_of=gh.cell_of.t().contiguous().t())


class GridHash2(NamedTuple):
    """Two-level grid: coarse guarantees the search radius, fine removes
    the slot-exhaustion bias when cell >> point spacing. Queries scan both
    and keep the nearer."""

    coarse: GridHash
    fine: GridHash


def grid2_build(pts: torch.Tensor, mask: torch.Tensor, radius,
                coarse_dims: tuple = (64, 64, 64),
                fine_dims: tuple = (96, 96, 96),
                coarse_slots: int = 16, fine_slots: int = 8) -> GridHash2:
    """Both levels over the masked AABB: coarse cell = `radius` (the
    correspondence radius), fine cell = radius / 4."""
    coarse_cell = _scalar(radius, pts.device)
    fine_cell = coarse_cell / 4.0
    lo = torch.amin(torch.where(mask[:, None], pts, torch.inf), dim=0)
    return GridHash2(
        coarse=_slots_together(grid_hash_build(
            pts, mask, lo - coarse_cell, coarse_cell, coarse_dims,
            coarse_slots)),
        fine=_slots_together(grid_hash_build(
            pts, mask, lo - fine_cell, fine_cell, fine_dims, fine_slots)))


def grid2_query(gh2: GridHash2, target_pts: torch.Tensor,
                query_pts: torch.Tensor, query_mask: torch.Tensor,
                coarse_dims: tuple = (64, 64, 64),
                fine_dims: tuple = (96, 96, 96)):
    """1-NN over both levels; the fine level wins only when strictly
    nearer."""
    ic, dc = grid_hash_query(gh2.coarse, target_pts, query_pts, query_mask,
                             coarse_dims)
    iff, df = grid_hash_query(gh2.fine, target_pts, query_pts, query_mask,
                              fine_dims)
    take_fine = df < dc
    return torch.where(take_fine, iff, ic), torch.where(take_fine, df, dc)


def nearest_neighbors(target_pts: torch.Tensor, target_mask: torch.Tensor,
                      query_pts: torch.Tensor, query_mask: torch.Tensor,
                      cell: float, dims: tuple = (64, 64, 64),
                      slots: int = 4):
    """Build a grid over the target's AABB and query 1-NN; `cell` should
    be about the correspondence radius (queries see +-1 cell)."""
    big = torch.where(target_mask[:, None], target_pts, torch.inf)
    cell = _scalar(cell, target_pts.device)
    lo = torch.amin(big, dim=0) - cell
    gh = grid_hash_build(target_pts, target_mask, lo, cell, dims, slots)
    return grid_hash_query(gh, target_pts, query_pts, query_mask, dims)


@functools.partial(jit, static_argnames=("dims", "k", "chunk"))
def grid_hash_query_knn(gh: GridHash, target_pts: torch.Tensor,
                        query_pts: torch.Tensor, query_mask: torch.Tensor,
                        dims: tuple, k: int, chunk: int = 8192):
    """k-NN over the 27-cell neighbourhood (27*slots candidates a query).

    Returns (idx (Q,k) int32 [-1 pad], dist (Q,k) f32 [inf pad]), nearest
    first; self-matches are not excluded. The reference's lax.top_k puts
    equal distances in candidate-column order; torch.topk does not promise
    an order, so candidates are ranked by one unique int64 key: the
    distance's bits (order-preserving for d2 >= 0, inf included) above the
    column."""
    nq = query_pts.shape[0]
    ncol = 27 * gh.cell_of.shape[0]
    kk = min(k, ncol)
    shift = ncol.bit_length()
    dev = query_pts.device
    idx = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    dist = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
    cols = torch.arange(ncol, dtype=torch.int64, device=dev)
    for s, e in _chunks(nq, chunk):
        cand, d2 = _candidate_d2(gh, target_pts, query_pts[s:e], dims)
        key = (d2.view(torch.int32).to(torch.int64) << shift) | cols
        top = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
        col = top & ((1 << shift) - 1)
        ik = torch.gather(cand, 1, col)
        dk = torch.sqrt(torch.clamp(torch.gather(d2, 1, col), min=0.0))
        good = (ik >= 0) & query_mask[s:e, None]
        idx[s:e, :kk] = torch.where(good, ik, -1)
        dist[s:e, :kk] = torch.where(good, dk, torch.inf)
    return idx, dist


def knn_neighbors(pts: torch.Tensor, mask: torch.Tensor, radius: float,
                  k: int, dims: tuple = (48, 48, 48), slots: int = 48):
    """Self k-NN of a cloud over a grid sized so one cell ~ the search
    radius (the SPFH / normal-estimation neighbourhoods)."""
    dev = pts.device
    lo = torch.amin(torch.where(mask[:, None], pts, torch.inf), dim=0) - radius
    hi = torch.amax(torch.where(mask[:, None], pts, -torch.inf),
                    dim=0) + radius
    # cell >= extent/(dims-1) so the grid always covers the cloud. The
    # reference divides by the constant dims-1 inside jit, which XLA
    # turns into a multiply by its float32 reciprocal: so here.
    recip = float(np.float32(1.0) / np.float32(min(dims) - 1))
    extent = torch.amax(hi - lo)
    cell = torch.maximum(_scalar(radius, dev), extent * recip)
    gh = grid_hash_build(pts, mask, lo, cell, dims, slots)
    return grid_hash_query_knn(gh, pts, pts, mask, dims, k)
