"""Shared CLI plumbing: argument parsing, logging, input loading.

Port of ``repas_tpu/apps/_common.py``, plus ``add_device_arg``: every
port CLI takes ``--device`` (default ``cuda``) and resolves it with
``core.device.host_data_device``, so without a card it raises rather than
running on the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repas_tpu_torch.core.calib import Intrinsics, load_intrinsics_json
from repas_tpu_torch.io.image import read_depth_png, read_image
from repas_tpu_torch.utils.logging import get_logger

log = get_logger("apps")


def add_intrinsics_args(p: argparse.ArgumentParser):
    p.add_argument("--intrinsics", type=Path, required=False,
                   help="intrinsics JSON (lean/bundle/realsense schema)")
    p.add_argument("--fx", type=float)
    p.add_argument("--fy", type=float)
    p.add_argument("--cx", type=float)
    p.add_argument("--cy", type=float)


def add_device_arg(p: argparse.ArgumentParser):
    """--device: where the device stages run (resolve it with
    core.device.host_data_device: cuda by default, raising without a
    card)."""
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages (default cuda;"
                        " raises without a card)")


def resolve_intrinsics(args, width: int, height: int) -> Intrinsics:
    if args.intrinsics:
        intr = load_intrinsics_json(args.intrinsics)
        return intr.scaled(width, height)
    if args.fx:
        return Intrinsics(fx=args.fx, fy=args.fy or args.fx,
                          cx=args.cx if args.cx is not None else width / 2,
                          cy=args.cy if args.cy is not None else height / 2,
                          width=width, height=height)
    raise SystemExit("provide --intrinsics JSON or --fx/--fy/--cx/--cy")


def load_rgb(path) -> np.ndarray:
    img = read_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def load_depth_m(path, scale: float = 0.001) -> np.ndarray:
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    return read_depth_png(path, scale)


def to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array as a tensor on `dev` (the port's jnp.asarray)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def to_host(nt):
    """A NamedTuple of tensors (Detections, FusedPose) as host numpy
    arrays."""
    return type(nt)(*(x.cpu().numpy() for x in nt))


def frame0(nt):
    """Frame 0 of a batched NamedTuple of tensors, as host numpy arrays."""
    return to_host(type(nt)(*(x[0] for x in nt)))


def emit_json(obj, path=None):
    s = json.dumps(obj, indent=2, default=_np_default)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(s)
        log.info("wrote %s", path)
    else:
        print(s)


def _np_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, Path):
        return str(o)
    raise TypeError(type(o))
