"""CAD placement and refinement.

Port of ``repas_tpu/cloud/cad.py``: host-side orchestration with the
scene's voxel filter, normals and point-to-plane ICP on the device.

  * place_cad_at_anchor: scale (units -> m) about the CAD centroid, rotate
    by R_avg about the CAD origin, translate the origin to the anchor,
    optional ZYX pre-rotation about the anchor. Each step is recorded as a
    4x4 and accumulated in float64 numpy. The reference asks for float64
    step matrices, but JAX runs with x64 off and builds them in float32;
    the port builds the same float32 steps.
  * refine_with_icp: sample the CAD surface (50k), voxel the scene (5 mm),
    estimate normals, point-to-plane ICP; report fitness, RMSE, the
    rotation and translation of the refinement. The scene goes to
    ``device`` (the card unless named; core/device.py).
  * apply_pose_txt: scale CAD units -> m about the origin, then the 4x4.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repas_tpu_torch.cloud.filters import voxel_downsample
from repas_tpu_torch.cloud.normals import estimate_normals
from repas_tpu_torch.cloud.registration import icp_point_to_plane
from repas_tpu_torch.core.config import CadConfig, ICPConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.transforms import (T_scale_about_point, T_translate,
                                             euler_zyx_to_R, make_T,
                                             rotation_angle_deg)
from repas_tpu_torch.io.ply import PointCloud, TriangleMesh
from repas_tpu_torch.kernels.image import _fma


def _host(x) -> np.ndarray:
    """numpy view of an array or a tensor (on any device)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _f32(x) -> torch.Tensor:
    """A host float32 tensor of x, rounded as jnp.asarray(x, float32)."""
    return torch.from_numpy(np.asarray(_host(x), dtype=np.float32))


def _rotate_about(R: torch.Tensor, p: torch.Tensor) -> np.ndarray:
    """T_rotate_about_point(R, p) in float32, with R @ p summed as XLA's
    CPU dot sums it, fma(R2, p2, fma(R1, p1, R0 p0)) (probed), so the step
    equals the reference's bit for bit."""
    Rp = _fma(R[:, 2], p[2], _fma(R[:, 1], p[1], R[:, 0] * p[0]))
    return make_T(R, p - Rp).numpy()


@dataclass
class PlacementResult:
    T_cad_world: np.ndarray                 # accumulated 4x4
    steps: list = field(default_factory=list)  # [(name, 4x4), ...]
    origin_world: np.ndarray = None         # CAD origin after placement

    def record(self, name: str, T: np.ndarray):
        self.steps.append((name, np.asarray(T)))
        self.T_cad_world = np.asarray(T) @ self.T_cad_world

    def provenance(self) -> dict:
        return {
            "transform_order": [n for n, _ in self.steps],
            "transforms": {n: t.tolist() for n, t in self.steps},
            "T_cad_world": np.asarray(self.T_cad_world).tolist(),
        }


def place_cad_at_anchor(cad, R_avg, anchor_P_depth,
                        cfg: CadConfig = CadConfig()) -> PlacementResult:
    """Compute the CAD->world transform (does not mutate `cad`): centroid
    c0 (CAD units) -> scale S about c0 -> the CAD origin is now at
    c0 (1 - S) -> rotate R_avg about that origin -> translate the origin to
    the anchor -> optional ZYX pre-rotation about the anchor. R_avg and
    the anchor may be arrays or tensors on any device."""
    verts = cad.vertices if isinstance(cad, TriangleMesh) else cad.points
    c0 = np.asarray(verts).mean(axis=0)
    S = float(cfg.units_to_meters)

    res = PlacementResult(T_cad_world=np.eye(4))
    res.record("scale_about_centroid",
               T_scale_about_point(S, _f32(c0)).numpy())

    origin_local = c0 * (1.0 - S)       # where (0,0,0) landed after scaling
    res.record("rotate_Ravg_about_origin",
               _rotate_about(_f32(R_avg), _f32(origin_local)))

    anchor = np.asarray(_host(anchor_P_depth), dtype=np.float64)
    res.record("translate_origin_to_anchor",
               T_translate(_f32(anchor - origin_local)).numpy())

    if any(abs(a) > 1e-6 for a in cfg.pre_rot_deg_zyx):
        # torch's float32 sin/cos round differently from XLA's: this
        # step may differ from the reference's by an ulp
        Rpre = euler_zyx_to_R(*cfg.pre_rot_deg_zyx)
        res.record("pre_rot_zyx_about_anchor",
                   _rotate_about(Rpre, _f32(anchor)))

    res.origin_world = anchor
    return res


def transform_geometry(cad, T: np.ndarray):
    return cad.transformed(_host(T))


def refine_with_icp(cad, scene: PointCloud, cfg: ICPConfig = ICPConfig(),
                    seed: int = 0, device=None):
    """Sample the CAD (a mesh: `cfg.cad_samples` area-weighted points; a
    cloud: that many of its points without replacement, both from numpy's
    generator seeded by `seed`, as the reference), voxel the scene, take
    its normals and run point-to-plane ICP from the CAD onto the scene on
    `device` (default: the card). Returns (report dict, T_icp 4x4 float64
    numpy). The normals' sample is drawn from a torch generator, not the
    reference's threefry stream."""
    if isinstance(cad, TriangleMesh):
        src = cad.sample_points_uniformly(cfg.cad_samples, seed=seed).points
    else:
        src = cad.points
        if len(src) > cfg.cad_samples:
            idx = np.random.default_rng(seed).choice(
                len(src), cfg.cad_samples, replace=False)
            src = src[idx]
    dev = host_data_device(device)
    src = _f32(src).to(dev)
    src_mask = torch.ones(src.shape[0], dtype=torch.bool, device=dev)

    tgt = _f32(scene.points).to(dev)
    tgt_mask = torch.ones(tgt.shape[0], dtype=torch.bool, device=dev)
    if cfg.scene_voxel > 0:
        tgt, _, _, tgt_mask = voxel_downsample(tgt, tgt_mask,
                                               cfg.scene_voxel)
    normals, _ = estimate_normals(tgt, tgt_mask, k=cfg.normal_max_nn,
                                  radius=cfg.normal_radius)

    result = icp_point_to_plane(
        src, src_mask, tgt, tgt_mask, normals,
        max_corr_dist=cfg.max_corr_dist, max_iters=cfg.max_iters,
        rel_tol=cfg.rel_tol)
    T = result.T.cpu().numpy().astype(np.float64)
    dR = float(rotation_angle_deg(torch.eye(3), _f32(T[:3, :3])))
    report = {
        "fitness": float(result.fitness),
        "inlier_rmse": float(result.inlier_rmse),
        "iterations": int(result.iterations),
        "delta_rotation_deg": dR,
        "delta_translation_mm": float(np.linalg.norm(T[:3, 3]) * 1000.0),
    }
    return report, T


def apply_pose_txt(cad, T: np.ndarray, units_to_meters: float = 0.001):
    """Scale CAD units -> meters about the origin, then apply the validated
    4x4. Returns (geometry, T_total)."""
    S = np.eye(4) * units_to_meters
    S[3, 3] = 1.0
    T_total = np.asarray(T, dtype=np.float64) @ S
    return cad.transformed(T_total), T_total
