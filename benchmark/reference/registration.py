"""Plain reference for cloud registration: numpy in float64, nothing of
the program.

A job registers a source cloud onto a target cloud that the benchmark
drew as two independent samplings of one surface, the source moved by a
known rigid motion (``benchmark/jobs.py``). The transform that maps the
source onto the target is that motion, whatever sampling noise the
points carry; it is what any sound registration recovers, so the
program's transform is judged against it:

  reg_t_mm   the largest gap of the translation, in millimetres
  reg_R_deg  the largest angle between the rotations, in degrees

The fitness is not compared: every source point lies within the ICP
distance (1.5 voxels, about 42 mm) of the target at the true pose and at
poses far from it alike, so no fitness separates a sound run from the
control. Nor is the inlier RMSE: the program's correspondences come from
a grid of bounded slots, which finds a near neighbour and not always the
nearest, so its RMSE is its own.

The global stage's transform and the target normals (kernel K1) are not
judged: ``register_clouds`` returns ICP's result, RANSAC's fitness and
the voxel, and keeps RANSAC's transform and the normals to itself, so
only a second program built for the check could read them. A fault of
either shows here only where it moves ICP's transform; RANSAC's fitness
reads about 1 at the true pose and at the half turn alike, so it is not
compared. ``control`` puts the motion, rounded to bfloat16, in the
program's place.
"""
from __future__ import annotations

import numpy as np
import torch


def angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    s = np.linalg.norm([Ra.T @ Rb - Rb.T @ Ra]) / (2 * np.sqrt(2))
    return float(np.degrees(np.arctan2(s, c)))


def judge(jobs: list, control: bool = False) -> dict:
    """`jobs`: ((T (4,4), fitness, rmse, iterations, ransac fitness), R,
    t) per judged job: the program's outputs and the motion drawn."""
    out = dict(reg_t_mm=0.0, reg_R_deg=0.0)
    for (T, *_), R, t in jobs:
        if control:
            low = torch.tensor(np.concatenate([R, t[:, None]], 1)).to(
                torch.bfloat16).to(torch.float64).numpy()
            T = np.eye(4)
            T[:3] = low
        out["reg_t_mm"] = max(out["reg_t_mm"],
                              1e3 * float(np.abs(T[:3, 3] - t).max()))
        out["reg_R_deg"] = max(out["reg_R_deg"], angle_deg(T[:3, :3], R))
    return out
