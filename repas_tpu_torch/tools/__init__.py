"""Measurement tools (port of the repository's ``tools/`` scripts).

Each runs on the card unless given ``--device cpu`` (without a card it
raises: ``core.device.host_data_device``), first prints the card's name
and power limit as ``nvidia-smi`` gives them, then what the JAX tool
prints, under the same names:

  python -m repas_tpu_torch.tools.profile_stages [--batch 16] [--iters 10]
      ms/frame of every cumulative detector stage prefix at 720p, then
      detect_tags, the fused point cloud and process_frames whole
  python -m repas_tpu_torch.tools.micro_perf [section ...] [--iters 20]
      variants of the hot stages: gray decim patches dmapatch2 fusion
      pnpiters pointcloud (default: gray patches pointcloud)
  python -m repas_tpu_torch.tools.reconstruct_compare [--n N]
      Poisson at dims 128/256 and ball pivoting on a sphere cloud: one
      JSON line per method with its vertex error in mm
  python -m repas_tpu_torch.tools.canopy_reference_parity --captures DIR \
      [--stamps STAMP ...]
      the reference's cv2 GrabCut canopy algorithm over five seeds per
      capture; host-only OpenCV code, so it takes no --device and
      prints no card line

A ms/frame is the host clock around ``iters`` calls between two
``torch.cuda.synchronize()``, divided by the batch; the port runs
eagerly, so it includes the host's launch time.
"""
from __future__ import annotations

import subprocess
import time

import torch

__all__ = ["card_line", "sync", "ms_per_frame"]


def card_line(dev: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader``), or "cpu" off the card."""
    if dev.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[dev.index or 0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ms_per_frame(fn, args, dev: torch.device, iters: int, batch: int):
    """One warm call of fn(*args), then `iters` calls between two
    synchronisations on the host clock. Returns (ms per frame, the last
    output's sum as a float)."""
    fn(*args)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(dev)
    dt = (time.perf_counter() - t0) / iters / batch * 1e3
    return dt, float(torch.sum(out))
