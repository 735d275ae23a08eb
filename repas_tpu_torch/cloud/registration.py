"""Point-to-plane ICP and the two-stage registration recipe.

Port of ``repas_tpu/cloud/registration.py``. ICP is a compiled step on
the card (``core.jit``; `max_iters`, `dims` and `slots` static, the
distances and tolerance 0-d tensors, as the reference jits it), and the
reference's ``lax.while_loop`` is ``core.jit.while_loop`` over (T, rmse,
fitness, iteration, done): captured, one WHILE graph node whose body is
one iteration (grid-hash 1-NN correspondences, distance gating at
max_corr_dist, the linearised point-to-plane 6x6 solve, the SE(3)
update, fitness and inlier RMSE as Open3D reports them), so a replay
reads nothing on the host; on the CPU a Python loop that reads the
condition before each iteration. ``register_clouds`` runs each stage as
its own compiled step, as the reference does, and reads the host where
it does: the AABB, the downsampled counts, RANSAC's T and fitness, and
ICP's iteration count.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repas_tpu_torch.cloud.filters import compact_masked, voxel_downsample
from repas_tpu_torch.cloud.fpfh import (fpfh_features, match_features,
                                        ransac_registration)
from repas_tpu_torch.cloud.knn import grid2_build, grid2_query
from repas_tpu_torch.cloud.normals import estimate_normals_grid
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.jit import jit, while_loop
from repas_tpu_torch.core.precision import cusolver
from repas_tpu_torch.core.transforms import make_T, rodrigues


class ICPResult(NamedTuple):
    T: torch.Tensor            # (4,4) source -> target refinement
    fitness: torch.Tensor      # matched fraction of source points
    inlier_rmse: torch.Tensor  # RMSE over matched pairs
    iterations: int            # iterations run, the converging one included


def _metrics(ok: torch.Tensor, dist: torch.Tensor, n_src: torch.Tensor):
    """(inlier RMSE, fitness) of gated correspondences. As in the
    reference, a query with no candidate at all has dist inf, and 0 * inf
    makes the RMSE NaN (the loop then never converges early)."""
    w = ok.to(torch.float32)
    m = torch.clamp(torch.sum(w), min=1.0)
    return torch.sqrt(torch.sum(w * dist * dist) / m), torch.sum(w) / n_src


def icp_point_to_plane(src: torch.Tensor, src_mask: torch.Tensor,
                       tgt: torch.Tensor, tgt_mask: torch.Tensor,
                       tgt_normals: torch.Tensor,
                       max_corr_dist: float = 0.05,
                       max_iters: int = 100,
                       rel_tol: float = 1e-6,
                       T_init=None,
                       dims: tuple = (64, 64, 64),
                       slots: int = 4) -> ICPResult:
    """src (S,3)+mask, tgt (T,3)+mask+normals, on one device. Stops after
    the step whose RMSE and fitness both moved less than `rel_tol`
    (relative, absolute), or after max_iters; the result's metrics are
    evaluated once more at the final T. `T_init` may lie on the host;
    `iterations` is read from the device once, after the step."""
    if T_init is not None:
        T_init = torch.as_tensor(T_init, dtype=torch.float32).to(src.device)
    T, fit, rmse, it = _icp(src, src_mask, tgt, tgt_mask, tgt_normals,
                            max_corr_dist, max_iters, rel_tol, T_init, dims,
                            slots)
    return ICPResult(T=T, fitness=fit, inlier_rmse=rmse, iterations=int(it))


@functools.partial(jit, static_argnames=("max_iters", "dims", "slots"),
                   scalar_argnames=("max_corr_dist", "rel_tol"))
def _icp(src, src_mask, tgt, tgt_mask, tgt_normals, max_corr_dist,
         max_iters, rel_tol, T_init, dims, slots):
    """icp_point_to_plane's step: (T, fitness, inlier RMSE, iterations
    (), int32)."""
    f32 = torch.float32
    src = src.to(f32)
    tgt = tgt.to(f32)
    dev = src.device
    T0 = torch.eye(4, dtype=f32, device=dev) if T_init is None else T_init
    # two-level grid: coarse cell = max_corr_dist covers the radius, fine
    # cell = max_corr_dist / 4 keeps the NN unbiased on dense targets
    gh = grid2_build(tgt, tgt_mask, max_corr_dist, coarse_dims=dims,
                     coarse_slots=4 * slots, fine_slots=2 * slots)
    n_src = torch.clamp(torch.sum(src_mask.to(torch.int32)), min=1)
    eye6 = 1e-9 * torch.eye(6, dtype=f32, device=dev)

    def correspondences(T):
        p = src @ T[:3, :3].T + T[:3, 3]
        nn, dist = grid2_query(gh, tgt, p, src_mask, coarse_dims=dims)
        ok = src_mask & (nn >= 0) & (dist <= max_corr_dist)
        nn_s = torch.clamp(nn, min=0).to(torch.int64)
        return p, tgt[nn_s], tgt_normals[nn_s], ok, dist

    def step(state):
        T, prev_rmse, prev_fit, it, done = state
        p, q, n, ok, dist = correspondences(T)
        w = ok.to(f32)
        r = torch.sum((p - q) * n, dim=1)
        J = torch.cat([torch.linalg.cross(p, n, dim=1), n], dim=1)  # (S,6)
        Jw = J * w[:, None]
        # solve_ex reads no status; cuSOLVER, since the default heuristic
        # may route a small solve to MAGMA, which synchronises
        with cusolver(dev):
            x = torch.linalg.solve_ex(J.T @ Jw + eye6, Jw.T @ r).result
        T_new = make_T(rodrigues(-x[:3]), -x[3:]) @ T
        rmse, fit = _metrics(ok, dist, n_src)
        converged = ((torch.abs(prev_rmse - rmse)
                      < rel_tol * torch.clamp(prev_rmse, min=1e-12))
                     & (torch.abs(prev_fit - fit) < rel_tol))
        return T_new, rmse, fit, it + 1, done | converged

    def cond(state):
        _, _, _, it, done = state
        return (it < max_iters) & ~done

    state = (T0, torch.full((), torch.inf, dtype=f32, device=dev),
             torch.zeros((), dtype=f32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    T, _, _, it, _ = while_loop(cond, step, state, max_trips=max_iters,
                                unroll=False)

    # final metrics at the converged transform (Open3D evaluates once more)
    _, _, _, ok, dist = correspondences(T)
    rmse, fit = _metrics(ok, dist, n_src)
    return T, fit, rmse, it


def evaluate_registration(src, src_mask, tgt, tgt_mask, T,
                          max_corr_dist: float = 0.05,
                          dims: tuple = (64, 64, 64)):
    """Open3D evaluate_registration: (fitness, inlier RMSE) of T (which
    may lie on the host)."""
    T = torch.as_tensor(T, dtype=torch.float32).to(tgt.device)
    return _evaluate(src, src_mask, tgt, tgt_mask, T, max_corr_dist, dims)


@functools.partial(jit, static_argnames=("dims",),
                   scalar_argnames=("max_corr_dist",))
def _evaluate(src, src_mask, tgt, tgt_mask, T, max_corr_dist, dims):
    f32 = torch.float32
    tgt = tgt.to(f32)
    gh = grid2_build(tgt, tgt_mask, max_corr_dist, coarse_dims=dims)
    p = src.to(f32) @ T[:3, :3].T + T[:3, 3]
    nn, dist = grid2_query(gh, tgt, p, src_mask, coarse_dims=dims)
    ok = src_mask & (nn >= 0) & (dist <= max_corr_dist)
    n_src = torch.clamp(torch.sum(src_mask.to(torch.int32)), min=1)
    rmse, fit = _metrics(ok, dist, n_src)
    return fit, rmse


def _aabb_diag(src, src_mask, tgt, tgt_mask) -> float:
    """Diagonal of the combined AABB of the valid points (one host read
    of a scalar)."""
    lo = torch.minimum(
        torch.amin(torch.where(src_mask[:, None], src, torch.inf), dim=0),
        torch.amin(torch.where(tgt_mask[:, None], tgt, torch.inf), dim=0))
    hi = torch.maximum(
        torch.amax(torch.where(src_mask[:, None], src, -torch.inf), dim=0),
        torch.amax(torch.where(tgt_mask[:, None], tgt, -torch.inf), dim=0))
    return float(torch.linalg.vector_norm(hi - lo))


def _cloud(pts, mask, device):
    """(pts f32, mask bool) as tensors: tensors stay where they lie; numpy
    input goes to host_data_device(device) (CUDA unless named, and a
    raise without a card)."""
    dev = pts.device if torch.is_tensor(pts) else host_data_device(device)
    return (torch.as_tensor(pts, dtype=torch.float32).to(dev),
            torch.as_tensor(mask).to(device=dev, dtype=torch.bool))


def global_register_fpfh(src, src_mask, tgt, tgt_mask, voxel: float,
                         capacity: int = 8192, n_hypotheses: int = 8192,
                         edge_check: float = 0.9, seed: int = 0,
                         device=None):
    """Global registration at the reference's scales: voxel downsample
    both clouds, compact them to `capacity` slots, normals at 2*voxel,
    FPFH at 5*voxel, feature matching, and batched 3-point RANSAC with
    the edge-length 0.9 and distance 2.5*voxel checkers (seeded by
    `seed`).

    Returns (T (4,4) float64 numpy, fitness float, n_down int: if n_down
    exceeds capacity the extra voxels were dropped)."""
    clouds = []
    n_down = 0
    for pts, mask in ((src, src_mask), (tgt, tgt_mask)):
        pts, mask = _cloud(pts, mask, device)
        pd, _, _, md = voxel_downsample(pts, mask, voxel)
        pc, mc, nv = compact_masked(pd, md, capacity)
        n_down = max(n_down, int(nv))
        nrm, _ = estimate_normals_grid(pc, mc, k=24, radius=2.0 * voxel,
                                       dims=(32, 32, 32), slots=32)
        feat = fpfh_features(pc, nrm, mc, radius=5.0 * voxel, k=48,
                             dims=(32, 32, 32), slots=32)
        clouds.append((pc, mc, feat))
    (sp, sm, sf), (tp, tm, tf) = clouds
    corr, _ = match_features(sf, sm, tf, tm, chunk=1024)
    T, fitness = ransac_registration(sp, sm, tp, tm, corr,
                                     dist_thresh=2.5 * voxel,
                                     edge_check=edge_check,
                                     n_hypotheses=n_hypotheses, key=seed)
    return T.cpu().numpy().astype(np.float64), float(fitness), n_down


def register_clouds(src, src_mask, tgt, tgt_mask, voxel: float | None = None,
                    capacity: int = 8192, n_hypotheses: int = 8192,
                    icp_iters: int = 100, seed: int = 0,
                    icp_dims: tuple = (64, 64, 64), device=None):
    """The reference's two-stage alignment: voxel = 2 % of the combined
    AABB diagonal (at least 1 mm), FPFH + RANSAC on the downsampled
    clouds, then point-to-plane ICP on the full clouds at 1.5*voxel.

    Tensor inputs run where they lie; numpy inputs on `device` (CUDA
    unless named). Returns (ICPResult, ransac_fitness, voxel)."""
    src, src_mask = _cloud(src, src_mask, device)
    tgt, tgt_mask = _cloud(tgt, tgt_mask, device)
    if voxel is None:
        voxel = max(0.02 * _aabb_diag(src, src_mask, tgt, tgt_mask), 1e-3)
    T0, fit_g, _ = global_register_fpfh(
        src, src_mask, tgt, tgt_mask, voxel, capacity=capacity,
        n_hypotheses=n_hypotheses, seed=seed)
    nrm_t, _ = estimate_normals_grid(tgt, tgt_mask, k=16,
                                     radius=2.0 * voxel)
    res = icp_point_to_plane(src, src_mask, tgt, tgt_mask, nrm_t,
                             max_corr_dist=1.5 * voxel,
                             max_iters=icp_iters, T_init=T0, dims=icp_dims)
    return res, fit_g, voxel
