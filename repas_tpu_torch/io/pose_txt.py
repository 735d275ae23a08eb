"""4x4 pose-matrix text I/O with validation.

Port of ``repas_tpu/io/pose_txt.py`` (host numpy, unchanged).

Matches load_transform_matrix (export_6dof.py:16-31): whitespace-separated
4x4 float matrix, validated for det(R) ~ 1 and orthonormality. This is the
ingestion path for FoundationPose `ob_in_cam/*.txt` outputs
(6dof_icp_export.py:23-24; sample at 6dof/20250917_164430.txt).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def load_transform_txt(path, validate: bool = True) -> np.ndarray:
    T = np.loadtxt(Path(path), dtype=np.float64)
    if T.shape != (4, 4):
        raise ValueError(f"{path}: expected 4x4 matrix, got {T.shape}")
    if validate:
        R = T[:3, :3]
        det = float(np.linalg.det(R))
        ortho = float(np.linalg.norm(R @ R.T - np.eye(3)))
        if abs(det - 1.0) > 1e-2 or ortho > 1e-2:
            raise ValueError(
                f"{path}: invalid rotation (det={det:.6f}, |RR^T - I|={ortho:.2e})")
        if not np.allclose(T[3], [0, 0, 0, 1], atol=1e-9):
            raise ValueError(f"{path}: last row must be [0 0 0 1], got {T[3]}")
    return T


def save_transform_txt(path, T) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, np.asarray(T, dtype=np.float64), fmt="%.18e")
