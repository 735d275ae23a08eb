"""The end-to-end frame pipeline.

Port of ``repas_tpu/pipeline.py`` (``FrameResult``, ``process_frame``,
``process_frames``) for an undistorted camera: RGB + aligned u16 depth ->
tag36h11 detection -> per-tag IPPE PnP -> depth-corrected translation ->
weighted quaternion fusion -> planar colored point cloud.

The batch is a leading dimension written out, every output has a fixed
capacity with masked slots, and nothing in ``process_frames`` waits for
the device or shapes a tensor by data, so the step is static-shaped.
RGB is packed once to one int32 word per pixel; grayscale and the point
cloud both read the packed form.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repas_tpu_torch.core.config import PipelineConfig
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
                   config: PipelineConfig = PipelineConfig()) -> FrameResult:
    """rgbs (B,H,W,3) uint8, depths_u16 (B,H,W) uint16 aligned to color,
    K (3,3) intrinsics. K may be an array; a float32 tensor already on the
    frames' device saves a blocking host-to-device copy per call."""
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
    packed = pack_rgb_u32(rgbs)
    det = detect_tags(gray_from_u32(packed), config.detector)
    depth_m = depth_to_meters(depths_u16, config.depth.depth_scale)
    pose = fuse_tag_poses(
        det.corners, det.ids, det.areas, det.valid, depth_m, K,
        config.pnp.tag_size_m, anchor_id=config.anchor_id,
        flip_z_ids=config.cad.flip_z_tag_ids, win=config.depth.center_win)
    pc = fused_pointcloud(depths_u16, packed, K,
                          scale=config.depth.depth_scale)
    return FrameResult(detections=det, pose=pose, pointcloud=pc)


def process_frame(rgb: torch.Tensor, depth_u16: torch.Tensor, K,
                  config: PipelineConfig = PipelineConfig()) -> FrameResult:
    """One frame: rgb (H,W,3) uint8, depth_u16 (H,W) uint16."""
    out = process_frames(rgb[None], depth_u16[None], K, config)
    return FrameResult(
        detections=Detections(*(x[0] for x in out.detections)),
        pose=FusedPose(*(x[0] for x in out.pose)),
        pointcloud=out.pointcloud[0])
