"""Grid-hash 1-NN query (kernel K4, ``csrc/grid_query.cu``).

``grid_query`` computes what ``cloud.knn.grid_hash_query_plain`` does,
bit for bit: for each query, the nearest target point among the slots of
the 27 grid cells around the query's cell, ties to the first candidate
column. It takes CUDA tensors only and launches K4 once; the CPU runs
the plain version (``cloud.knn.grid_hash_query`` chooses by device). K4
replaces no TPU kernel: the JAX package's ``grid_hash_query`` is
``jax.jit`` code that XLA fuses.
"""
from __future__ import annotations

import torch

from repas_tpu_torch.kernels import _build


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"grid_query: {what}")


def grid_query(cell_of: torch.Tensor, origin: torch.Tensor,
               cell: torch.Tensor, target: torch.Tensor,
               query: torch.Tensor, query_mask: torch.Tensor,
               dims: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """(nn_idx (Q,) int32 [-1 if none], nn_dist (Q,) float32 [inf]) from
    K4, one launch. `cell_of` (slots, cells) int32, read through its
    strides (fastest with a cell's slots side by side, as
    ``cloud.knn.grid2_build`` keeps it); `origin` (3,) and `cell` ()
    float32; `target` (N,3) and `query` (Q,3) float32 and `query_mask`
    (Q,) bool, contiguous; all on one CUDA device."""
    dev = query.device
    _need(dev.type == "cuda", f"needs CUDA tensors; got {dev}")
    _need(all(x.device == dev for x in (cell_of, origin, cell, target,
                                        query_mask)),
          "every tensor must lie on the query's device")
    nx, ny, nz = (int(d) for d in dims)
    _need(cell_of.dtype == torch.int32 and cell_of.dim() == 2
          and cell_of.shape[1] == nx * ny * nz and cell_of.shape[0] > 0,
          f"cell_of must be (slots, {nx * ny * nz}) int32; got "
          f"{tuple(cell_of.shape)} {cell_of.dtype}")
    _need(origin.dtype == torch.float32 and tuple(origin.shape) == (3,)
          and origin.is_contiguous(), "origin must be a contiguous (3,) "
          "float32 tensor")
    _need(cell.dtype == torch.float32 and cell.dim() == 0,
          "cell must be a 0-d float32 tensor")
    for name, x in (("target", target), ("query", query)):
        _need(x.dtype == torch.float32 and x.dim() == 2 and x.shape[1] == 3
              and x.is_contiguous(), f"{name} must be a contiguous (n,3) "
              f"float32 tensor; got {tuple(x.shape)} {x.dtype}")
    nq = query.shape[0]
    _need(query_mask.dtype == torch.bool
          and tuple(query_mask.shape) == (nq,)
          and query_mask.is_contiguous(),
          "query_mask must be a contiguous (Q,) bool tensor")
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    dist = torch.empty(nq, dtype=torch.float32, device=dev)
    if nq:
        _build.launch("repas_grid_query", dev, cell_of.data_ptr(),
                      cell_of.stride(0), cell_of.stride(1),
                      origin.data_ptr(), cell.data_ptr(), target.data_ptr(),
                      query.data_ptr(), query_mask.data_ptr(),
                      idx.data_ptr(), dist.data_ptr(), nq,
                      cell_of.shape[0], nx, ny, nz)
        _build.launches["grid_query"] += 1
    return idx, dist
