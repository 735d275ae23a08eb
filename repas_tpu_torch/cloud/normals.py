"""Normal estimation by local PCA, oriented toward the camera (Open3D
estimate_normals + orient_normals_towards_camera_location).

Port of ``repas_tpu/cloud/normals.py``. Each normal is the eigenvector of
the smallest eigenvalue of its neighbourhood's covariance (a batched 3x3
``torch.linalg.eigh``), its sign chosen to face the camera.
"""
from __future__ import annotations

import numpy as np
import torch

from repas_tpu_torch.cloud.filters import _choice, _generator, _sample_d2
from repas_tpu_torch.cloud.knn import _chunks, knn_neighbors

# torch.linalg.eigh on the card runs cusolverDnXsyevBatched, which refuses
# a batch of 32,768 3x3 matrices or more (CUSOLVER_STATUS_INVALID_VALUE;
# torch 2.11, CUDA 12.8, H100). Each matrix is solved alone, so splitting
# the batch changes no result.
_EIGH_BATCH = 16384


def _camera(camera, pts: torch.Tensor) -> torch.Tensor:
    if camera is None:
        return torch.zeros(3, dtype=pts.dtype, device=pts.device)
    return torch.as_tensor(camera, dtype=pts.dtype).to(pts.device)


def _pca_normals(p, nbr, within, cam):
    """Normals of points p (C,3) from neighbours nbr (C,k,3) weighted by
    `within` (C,k): the smallest eigenvector of the weighted covariance
    (plus a tiny ridge), flipped to face `cam`."""
    w = within.to(p.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mu = torch.sum(nbr * w, dim=1) / cnt
    dd = (nbr - mu[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", dd, dd)
    tr = (cov[:, 0, 0] + cov[:, 1, 1] + cov[:, 2, 2])[:, None, None]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    A = cov + 1e-12 * (tr + 1e-30) * eye
    nrm = torch.cat([torch.linalg.eigh(A[s:e])[1][:, :, 0]
                     for s, e in _chunks(A.shape[0], _EIGH_BATCH)])
    flip = torch.sum(nrm * (cam - p), dim=1) < 0
    return torch.where(flip[:, None], -nrm, nrm)


def estimate_normals_grid(pts: torch.Tensor, mask: torch.Tensor, k: int = 16,
                          radius: float = 0.02,
                          dims: tuple = (48, 48, 48), slots: int = 48,
                          chunk: int = 65536, camera=None):
    """Normals from the grid-hash k-NN (chunked, memory-bounded at any N)
    and a PCA per chunk of `chunk` points.

    Returns (normals (N,3), ok (N,) bool): ok needs 3 neighbours within
    `radius`."""
    cam = _camera(camera, pts)
    idx, dist = knn_neighbors(pts, mask, radius, k + 1, dims=dims,
                              slots=slots)
    nn = idx[:, 1:].to(torch.int64)              # drop self
    dist = dist[:, 1:]
    nrm = torch.zeros_like(pts)
    ok = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for s, e in _chunks(pts.shape[0], chunk):
        within = (dist[s:e] <= radius) & (nn[s:e] >= 0)
        nbr = pts[torch.clamp(nn[s:e], min=0)]
        nrm[s:e] = _pca_normals(pts[s:e], nbr, within, cam)
        ok[s:e] = torch.sum(within, dim=1) >= 3
    ok = ok & mask
    return torch.where(ok[:, None], nrm, 0.0), ok


def _normals_from_sample(pts: torch.Tensor, mask: torch.Tensor,
                         idx: torch.Tensor, k: int, radius: float, camera
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """estimate_normals against the sample points `idx`."""
    ref = pts[idx]
    d2 = _sample_d2(pts, ref, mask[idx])
    top = torch.topk(d2, k, dim=1, largest=False)
    del d2
    # the reference squares the float32 radius in float32
    r32 = np.float32(radius)
    within = top.values <= float(r32 * r32)
    nrm = _pca_normals(pts, ref[top.indices], within, _camera(camera, pts))
    ok = mask & (torch.sum(within, dim=1) >= 3)
    return torch.where(ok[:, None], nrm, 0.0), ok


def estimate_normals(pts: torch.Tensor, mask: torch.Tensor, k: int = 30,
                     radius: float = 0.02, sample: int = 4096,
                     camera=None, key: int | None = None):
    """Per-point normals from PCA of the k nearest neighbours within
    `radius` (Open3D hybrid search semantics), oriented toward `camera`
    (default: the origin). Neighbours are searched among `sample` points
    drawn without replacement from the valid ones (one (N, sample)
    distance matrix), with the generator seeded by `key` (default 1).

    Returns (normals (N,3), ok (N,) bool)."""
    gen = _generator(pts.device, 1 if key is None else key)
    idx = _choice(mask, min(sample, pts.shape[0]), False, gen)
    return _normals_from_sample(pts, mask, idx, k, radius, camera)
