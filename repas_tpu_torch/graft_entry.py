"""The system's two entry points from outside, on PyTorch.

Port of ``__graft_entry__.py``:

  entry(device=None)  -> (fn, (rgb, depth)): the single-frame 720p step
                         of the flagship pipeline (detect + PnP + point
                         cloud) and its example frame on `device`.
  dryrun_multichip(n) -> the batched pipeline step over an n-device
                         ``frames`` mesh plus the fusion gather and the
                         batch reduction, one step on 96x128 frames (the
                         shards' steps compiled); prints the JAX dry run's
                         line and returns its values.

Both run on the card unless given another device (``core/device.py``:
without a card they raise). The JAX module re-executes itself in a
subprocess to force its CPU platform; the port runs in process, and on
one card its mesh names ``cuda:0`` n times, one stream per shard. The
example frame is ``detect.render.example_frame``, the port's copy of
``__graft_entry__._example_frame``. ``entry()`` returns the plain step;
run as a script, the step is compiled first (``core.jit``, a CUDA graph
on the card), as the JAX script jits it.

    python -m repas_tpu_torch.graft_entry
"""
from __future__ import annotations

import torch

from repas_tpu_torch.core.config import DetectorConfig, PipelineConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.jit import jit
from repas_tpu_torch.detect.render import example_frame
from repas_tpu_torch.parallel.mesh import (batch_stats_psum, frames_mesh,
                                           fuse_views_allgather, shard_batch,
                                           sharded_frame_pipeline)
from repas_tpu_torch.pipeline import process_frame, process_frames

__all__ = ["entry", "dryrun_multichip"]

DRYRUN_H, DRYRUN_W = 96, 128
DRYRUN_DETECTOR = DetectorConfig(max_components=8, max_detections=4,
                                 ccl_iters=4, min_area_px=16.0,
                                 quad_decimate=1.0)


def entry(device=None):
    """The full 720p pipeline forward step: (fn, (rgb, depth)), fn(rgb,
    depth) -> (ids, corners, R_avg, anchor_P_depth, pointcloud), the
    example frame and K on `device` (default: CUDA)."""
    dev = host_data_device(device)
    rgb, depth, K = example_frame(720, 1280)
    K = torch.from_numpy(K).to(dev)
    cfg = PipelineConfig()

    def fn(rgb, depth):
        out = process_frame(rgb, depth, K, cfg)
        return (out.detections.ids, out.detections.corners,
                out.pose.R_avg, out.pose.anchor_P_depth, out.pointcloud)

    return fn, (torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev))


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Frame-DP over an n-device mesh + fusion collectives, one tiny step.

    `devices`: one per shard (default: the CUDA devices, repeated in turn;
    ``["cpu"] * n`` on the CPU). Prints the JAX dry run's line and returns
    its values: n_devices, frames, detections, fused_pts (the fused
    cloud's shape), mean_z and count.
    """
    mesh = frames_mesh(n_devices, devices)
    if mesh.size != n_devices:
        raise ValueError(f"need {n_devices} devices, have {mesh.size}")
    rgb, depth, K = example_frame(DRYRUN_H, DRYRUN_W)
    B = n_devices
    rgbs = torch.from_numpy(rgb).expand(B, *rgb.shape).contiguous()
    depths = torch.from_numpy(depth).expand(B, *depth.shape).contiguous()
    cfg = PipelineConfig(detector=DRYRUN_DETECTOR)
    # K on each shard's device: a compiled step copies nothing from the
    # host
    Ks = {k.device: k for k in (torch.from_numpy(K).to(d)
                                for d in set(mesh.devices))}

    run = sharded_frame_pipeline(
        lambda r, d: process_frames(r, d, Ks[r.device], cfg), mesh)
    out = run(shard_batch(rgbs, mesh), shard_batch(depths, mesh))

    # collectives: multi-view fusion + global stats (the point cloud is
    # planar (B, 6, H*W): rows x,y,z,r,g,b)
    pts = torch.movedim(out.pointcloud[:, :3, :], 1, -1)      # (B,N,3)
    valid = out.pointcloud[:, 2, :] > 0
    fused_pts, _ = fuse_views_allgather(mesh)(pts, valid)
    mean_z, count = batch_stats_psum(mesh)(
        out.pointcloud[:, 2, :].mean(dim=1),
        torch.ones((B,), dtype=torch.bool, device=mesh.devices[0]))

    ids = out.detections.ids
    if ids.shape[0] != B:
        raise AssertionError(f"{ids.shape[0]} frames out of {B}")
    res = {"n_devices": n_devices, "frames": B,
           "detections": int((ids >= 0).sum()),
           "fused_pts": tuple(int(s) for s in fused_pts[0].shape),
           "mean_z": float(mean_z), "count": int(count)}
    print(f"[dryrun_multichip] n_devices={n_devices} frames={B} "
          f"detections={res['detections']} fused_pts={res['fused_pts']} "
          f"mean_z={res['mean_z']:.3f} count={res['count']}")
    return res


if __name__ == "__main__":
    fn, args = entry()
    out = jit(fn)(*args)
    print("[entry] ids:", out[0].cpu().numpy())
    dryrun_multichip(8)
