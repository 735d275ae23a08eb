"""Normal estimation by local PCA, oriented toward the camera (Open3D
estimate_normals + orient_normals_towards_camera_location).

Port of ``repas_tpu/cloud/normals.py``. Each normal is the eigenvector of
the smallest eigenvalue of its neighbourhood's covariance (a batched 3x3
eigh: kernel K1, ``kernels/eig3.py``, on the card; ``torch.linalg.eigh``
on the CPU), its sign chosen to face the camera.

``estimate_normals_grid`` and ``estimate_normals``' step are compiled on
the card (``core.jit``, as the reference jits them): `k`, `dims`,
`slots`, `sample` and the chunks static, the radius a 0-d tensor.
``estimate_normals`` draws its sample before its step, from a seeded
``torch.Generator``, which a graph could not reseed.
"""
from __future__ import annotations

import functools

import torch

from repas_tpu_torch.cloud.filters import _choice, _generator, _sample_d2
from repas_tpu_torch.cloud.knn import _chunks, _scalar, knn_neighbors
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.kernels.eig3 import eig3

# rows of estimate_normals' (rows, sample) distance block: 512 MB at the
# default sample of 4,096 (the whole 720p frame at once is 15 GB)
SAMPLE_ROWS = 32768


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
    nrm = eig3(A)[1][:, :, 0]
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
    return _normals_grid(pts, mask, k, radius, dims, slots, chunk,
                         _camera(camera, pts))


@functools.partial(jit, static_argnames=("k", "dims", "slots", "chunk"),
                   scalar_argnames=("radius",))
def _normals_grid(pts, mask, k, radius, dims, slots, chunk, cam):
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
                         idx: torch.Tensor, k: int, radius, camera=None,
                         rows: int = SAMPLE_ROWS
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """estimate_normals against the sample points `idx`, `rows` points at
    a time (each row's top-k and PCA depend on that row alone). `camera`
    may lie on the host."""
    return _normals_step(pts, mask, idx, k, radius, _camera(camera, pts),
                         rows)


@functools.partial(jit, static_argnames=("k", "rows"),
                   scalar_argnames=("radius",))
def _normals_step(pts, mask, idx, k, radius, cam, rows):
    ref = pts[idx]
    ref_ok = mask[idx]
    # the reference squares the float32 radius in float32
    r = _scalar(radius, pts.device)
    r2 = r * r
    nrm = torch.empty_like(pts)
    n_within = torch.empty(pts.shape[0], dtype=torch.int64,
                           device=pts.device)
    for s, e in _chunks(pts.shape[0], rows):
        d2 = _sample_d2(pts[s:e], ref, ref_ok)
        top = torch.topk(d2, k, dim=1, largest=False)
        del d2
        within = top.values <= r2
        nrm[s:e] = _pca_normals(pts[s:e], ref[top.indices], within, cam)
        n_within[s:e] = torch.sum(within, dim=1)
    ok = mask & (n_within >= 3)
    return torch.where(ok[:, None], nrm, 0.0), ok


def estimate_normals(pts: torch.Tensor, mask: torch.Tensor, k: int = 30,
                     radius: float = 0.02, sample: int = 4096,
                     camera=None, key: int | None = None):
    """Per-point normals from PCA of the k nearest neighbours within
    `radius` (Open3D hybrid search semantics), oriented toward `camera`
    (default: the origin). Neighbours are searched among `sample` points
    drawn without replacement from the valid ones (the (N, sample)
    distances SAMPLE_ROWS rows at a time), with the generator seeded by
    `key` (default 1).

    Returns (normals (N,3), ok (N,) bool)."""
    gen = _generator(pts.device, 1 if key is None else key)
    idx = _choice(mask, min(sample, pts.shape[0]), False, gen)
    return _normals_from_sample(pts, mask, idx, k, radius, camera)
