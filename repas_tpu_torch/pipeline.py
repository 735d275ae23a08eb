"""The end-to-end frame pipeline.

Port of ``repas_tpu/pipeline.py`` (``FrameResult``, ``process_frame``,
``process_frames``): RGB + aligned u16 depth -> tag36h11 detection ->
per-tag IPPE PnP (with the lens's Brown-Conrady coefficients when given)
-> depth-corrected translation -> weighted quaternion fusion -> planar
colored point cloud (or none, with ``with_pointcloud=False``).

The batch is a leading dimension written out, every output has a fixed
capacity with masked slots, and nothing in ``process_frames`` waits for
the device or shapes a tensor by data, so the step is static-shaped.
RGB is packed once to one int32 word per pixel; grayscale and the point
cloud both read the packed form.

``process_frames_jit`` is the compiled step (``core/jit.py``), the
counterpart of the reference's ``jax.jit`` on ``process_frame`` vmapped
over the batch: on the card one CUDA graph per frame shape, config,
``with_pointcloud`` and ``dist``'s None-ness, replayed. It takes ``K``
and ``dist`` as tensors on the frames' device (a host array inside a
capture would be a pageable copy). ``process_frames`` itself stays
eager.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repas_tpu_torch.core.config import PipelineConfig
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.detect.detector import Detections, detect_tags
from repas_tpu_torch.kernels.image import gray_from_u32, pack_rgb_u32
from repas_tpu_torch.kernels.pointcloud import (depth_to_meters,
                                                fused_pointcloud)
from repas_tpu_torch.pose.fusion import FusedPose, fuse_tag_poses


class FrameResult(NamedTuple):
    detections: Detections
    pose: FusedPose
    pointcloud: torch.Tensor     # (B,6,H*W) planar [x,y,z,r,g,b] rows
                                 # (kernels.pointcloud.xyzrgb_rows for the
                                 #  (N,6) export layout)


def process_frames(rgbs: torch.Tensor, depths_u16: torch.Tensor, K,
                   config: PipelineConfig = PipelineConfig(),
                   with_pointcloud: bool = True, dist=None) -> FrameResult:
    """rgbs (B,H,W,3) uint8, depths_u16 (B,H,W) uint16 aligned to color,
    K (3,3) intrinsics; dist: optional distortion coefficients
    (k1,k2,p1,p2,k3[,k4,k5,k6]), None for an undistorted camera. K and
    dist may be arrays; float32 tensors already on the frames' device
    save a blocking host-to-device copy per call. Without
    `with_pointcloud` the cloud is (B,6,0) and kernel B3 does not run."""
    if rgbs.dtype != torch.uint8 or rgbs.ndim != 4 or rgbs.shape[-1] != 3:
        raise ValueError(f"process_frames: rgbs must be (B,H,W,3) uint8, got "
                         f"{tuple(rgbs.shape)} {rgbs.dtype}")
    if (depths_u16.dtype != torch.uint16
            or tuple(depths_u16.shape) != tuple(rgbs.shape[:3])
            or depths_u16.device != rgbs.device):
        raise ValueError("process_frames: depths_u16 must be (B,H,W) uint16 "
                         "on the frames' device, got "
                         f"{tuple(depths_u16.shape)} {depths_u16.dtype} on "
                         f"{depths_u16.device}")
    K = torch.as_tensor(K, dtype=torch.float32, device=rgbs.device)
    if dist is not None:
        # None stays None: the PnP solvers then skip the polynomial
        dist = torch.as_tensor(dist, dtype=torch.float32,
                               device=rgbs.device).reshape(-1)[:8]
        dist = torch.cat([dist, dist.new_zeros(8 - dist.shape[0])])
    packed = pack_rgb_u32(rgbs)
    det = detect_tags(gray_from_u32(packed), config.detector)
    depth_m = depth_to_meters(depths_u16, config.depth.depth_scale)
    pose = fuse_tag_poses(
        det.corners, det.ids, det.areas, det.valid, depth_m, K,
        config.pnp.tag_size_m, anchor_id=config.anchor_id,
        flip_z_ids=config.cad.flip_z_tag_ids, win=config.depth.center_win,
        dist=dist)
    if with_pointcloud:
        pc = fused_pointcloud(depths_u16, packed, K,
                              scale=config.depth.depth_scale)
    else:
        pc = torch.zeros((rgbs.shape[0], 6, 0), dtype=torch.float32,
                         device=rgbs.device)
    return FrameResult(detections=det, pose=pose, pointcloud=pc)


process_frames_jit = jit(process_frames,
                         static_argnames=("config", "with_pointcloud"))


def process_frame(rgb: torch.Tensor, depth_u16: torch.Tensor, K,
                  config: PipelineConfig = PipelineConfig(),
                  with_pointcloud: bool = True, dist=None) -> FrameResult:
    """One frame: rgb (H,W,3) uint8, depth_u16 (H,W) uint16."""
    out = process_frames(rgb[None], depth_u16[None], K, config,
                         with_pointcloud, dist)
    return FrameResult(
        detections=Detections(*(x[0] for x in out.detections)),
        pose=FusedPose(*(x[0] for x in out.pose)),
        pointcloud=out.pointcloud[0])
