"""Pose-dataset reader + 6DOF pose ingestion (C17).

Port of ``repas_tpu/io/dataset.py``, copied (host numpy): the same
layout, readers and pose-txt writer.

The reference drives FoundationPose with a dataset directory of
rgb/, depth/ (mm u16), mask/, cam_K.txt (custom_reader.py:7-50) and
consumes its per-frame ob_in_cam/*.txt 4x4 outputs
(run_custom.py:1-76, 6dof_icp_export.py:23-24). Rebuilding the learned
model is out of scope (SURVEY.md N7); this module keeps the interface:
the dataset format becomes the framework's sequence-dataset contract, and
pose outputs round-trip through io.pose_txt.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from repas_tpu_torch.io.image import read_image
from repas_tpu_torch.io.pose_txt import load_transform_txt, save_transform_txt


@dataclass
class SequenceFrame:
    index: int
    rgb: np.ndarray                    # (H,W,3) uint8
    depth_m: Optional[np.ndarray]      # (H,W) float32 meters
    mask: Optional[np.ndarray]         # (H,W) bool
    K: np.ndarray                      # (3,3)
    pose: Optional[np.ndarray] = None  # (4,4) object-in-camera if present
    stem: str = ""


class PoseSequenceDataset:
    """Directory layout: rgb/*.png, depth/*.png (mm u16), mask/*.png,
    cam_K.txt (3x3), optional ob_in_cam/*.txt poses."""

    def __init__(self, root, depth_scale: float = 0.001):
        self.root = Path(root)
        self.depth_scale = depth_scale
        self.color_files = sorted((self.root / "rgb").glob("*.png"))
        if not self.color_files:
            self.color_files = sorted((self.root / "rgb").glob("*.jpg"))
        k_path = self.root / "cam_K.txt"
        self.K = (np.loadtxt(k_path).reshape(3, 3)
                  if k_path.exists() else None)

    def __len__(self):
        return len(self.color_files)

    def _sibling(self, sub: str, stem: str) -> Optional[Path]:
        d = self.root / sub
        for ext in (".png", ".jpg", ".npy"):
            p = d / (stem + ext)
            if p.exists():
                return p
        cands = sorted(d.glob(stem + ".*")) if d.exists() else []
        return cands[0] if cands else None

    def __getitem__(self, i: int) -> SequenceFrame:
        cpath = self.color_files[i]
        stem = cpath.stem
        rgb = read_image(cpath)
        depth = None
        dpath = self._sibling("depth", stem)
        if dpath is not None:
            if dpath.suffix == ".npy":
                depth = np.load(dpath).astype(np.float32)
            else:
                depth = read_image(dpath).astype(np.float32) * self.depth_scale
        mask = None
        mpath = self._sibling("mask", stem) or self._sibling("masks", stem)
        if mpath is not None:
            m = read_image(mpath)
            mask = (m if m.ndim == 2 else m[..., 0]) > 0
        pose = None
        ppath = self.root / "ob_in_cam" / (stem + ".txt")
        if ppath.exists():
            pose = load_transform_txt(ppath)
        return SequenceFrame(index=i, rgb=rgb, depth_m=depth, mask=mask,
                             K=self.K, pose=pose, stem=stem)

    def __iter__(self) -> Iterator[SequenceFrame]:
        for i in range(len(self)):
            yield self[i]

    def write_pose(self, stem: str, T: np.ndarray) -> Path:
        """Write a per-frame 4x4 pose the way run_custom.py exports
        ob_in_cam/<stem>.txt."""
        out = self.root / "ob_in_cam" / f"{stem}.txt"
        save_transform_txt(out, T)
        return out
