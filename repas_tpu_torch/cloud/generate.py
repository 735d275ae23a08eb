"""Masked colored point-cloud generation.

Port of ``repas_tpu/cloud/generate.py``: RGB + depth in metres + binary
mask -> back-projection -> voxel downsample -> statistical outlier
removal -> normals toward the camera, each stage on fixed shapes and
masks. The reference jits the whole chain (`voxel`, `outlier_nb` and
`with_normals` static); on the card the port compiles it as three steps
(``core.jit``) with the two samples drawn between them, from seeded
``torch.Generator``s, which a graph could not reseed: back-projection
and downsampling, the outlier filter's step, the normals' step.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repas_tpu_torch.cloud.filters import (statistical_outlier_mask,
                                           voxel_downsample)
from repas_tpu_torch.cloud.normals import estimate_normals
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.kernels.pointcloud import rgbd_to_pointcloud


class MaskedCloud(NamedTuple):
    points: torch.Tensor
    colors: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor


def create_masked_pointcloud(rgb: torch.Tensor, depth_m: torch.Tensor, K,
                             mask: torch.Tensor | None = None,
                             voxel: float = 0.0,
                             outlier_nb: int = 20,
                             outlier_std: float = 2.0,
                             with_normals: bool = False,
                             min_depth: float = 0.0,
                             max_depth: float = 10.0) -> MaskedCloud:
    """One (H,W) frame -> a flat (H*W) cloud on the frame's device.
    voxel=0 skips downsampling, outlier_nb=0 skips outlier removal.

    max_depth defaults to 10 m: sensors mark invalid pixels with a
    saturated u16 (65535 mm), which would poison voxel grids and AABBs."""
    K = torch.as_tensor(K, dtype=torch.float32).to(depth_m.device)
    pts, cols, valid = _back_project(rgb, depth_m, K, mask, voxel,
                                     min_depth, max_depth)
    if outlier_nb:
        valid = statistical_outlier_mask(pts, valid, nb_neighbors=outlier_nb,
                                         std_ratio=outlier_std)
    if with_normals:
        normals, _ = estimate_normals(pts, valid)
    else:
        normals = torch.zeros_like(pts)
    pts = torch.where(valid[:, None], pts, 0.0)
    cols = torch.where(valid[:, None], cols, 0.0)
    return MaskedCloud(points=pts, colors=cols, normals=normals, valid=valid)


@functools.partial(jit, static_argnames=("voxel",),
                   scalar_argnames=("min_depth", "max_depth"))
def _back_project(rgb, depth_m, K, mask, voxel, min_depth, max_depth):
    """create_masked_pointcloud's first step: the flat cloud of the frame,
    voxel-downsampled where voxel > 0. Returns (pts, cols, valid)."""
    pts, cols, valid = rgbd_to_pointcloud(rgb, depth_m, K, mask=mask,
                                          min_depth=min_depth,
                                          max_depth=max_depth)
    if voxel and voxel > 0:
        pts, cols, _, valid = voxel_downsample(pts, valid, voxel,
                                               colors=cols)
    return pts, cols, valid
