"""Frame data-parallelism over a list of devices, with fusion collectives.

Port of ``repas_tpu/parallel/mesh.py`` (``frames_mesh``, ``shard_batch``,
``sharded_frame_pipeline``, ``fuse_views_allgather``,
``batch_stats_psum``) as a single controller, which is what the JAX mesh
is: one process drives every device of the mesh, and a sharded batch is
its shards, one contiguous chunk of frames per device, in order.

  * `sharded_frame_pipeline` — run a per-frame function on each shard on
    its device, each shard on a CUDA stream of its own, and concatenate
    the shards' outputs in order (no cross-device traffic until then).
    The function is compiled once per shard (``core.jit``, as the
    reference jits ``run``): on the card each shard replays a CUDA graph
    of its own, so the shards' replays never wait on each other.
  * `fuse_views_allgather`  — gather every shard's views into one fused
    cloud and copy it to every device of the mesh (peer copies).
  * `batch_stats_psum`      — masked mean and count over all shards.

No ``torch.distributed`` process group: the JAX package has no
multi-process execution either. A mesh may name one device more than
once (``frames_mesh(devices=["cuda:0", "cuda:0"])``, or ``"cpu"`` four
times in the CPU tests), which runs 2-8 shards on one card, each on its
own stream.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.jit import jit


@dataclass(frozen=True)
class FramesMesh:
    """The mesh's devices, one per shard, in shard order."""

    devices: tuple
    axis: str = "frames"

    @property
    def size(self) -> int:
        return len(self.devices)


class Shards(tuple):
    """A batch split along dim 0: one tensor per mesh device, in order."""


def frames_mesh(n_devices: int | None = None, devices=None,
                axis: str = "frames") -> FramesMesh:
    """A 1-D mesh over `devices`, cut to the first `n_devices`. Default:
    the CUDA devices torch sees, each once, or repeated in turn up to
    `n_devices` (so one card holds an n-shard mesh); raises without a
    card."""
    if devices is None:
        host_data_device("cuda")
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}"
                   for i in range(max(count, n_devices or 0))]
    devs = tuple(host_data_device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return FramesMesh(devs, axis)


def shard_batch(x: torch.Tensor, mesh: FramesMesh,
                axis: str = "frames") -> Shards:
    """Split x along dim 0 into mesh.size contiguous chunks, each on its
    device (the leading dimension must divide evenly, as for the
    reference's sharding)."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"batch of {x.shape[0]} does not split over "
                         f"{mesh.size} devices")
    return Shards(c.to(d, non_blocking=True)
                  for c, d in zip(torch.chunk(x, mesh.size), mesh.devices))


def _stream_on(dev: torch.device):
    """A new side stream on a CUDA device that waits for the device's
    current stream (where the shard's inputs were made), else None."""
    if dev.type != "cuda":
        return None
    s = torch.cuda.Stream(device=dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    return s


def _join(outs: list, dev: torch.device):
    """Concatenate per-shard output trees (tensors, tuples, NamedTuples,
    lists, dicts) along dim 0 onto `dev`."""
    first = outs[0]
    if torch.is_tensor(first):
        return torch.cat([o.to(dev) for o in outs])
    if isinstance(first, dict):
        return {k: _join([o[k] for o in outs], dev) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_join(list(f), dev) for f in zip(*outs)))
    if isinstance(first, (tuple, list)):
        return type(first)(_join(list(f), dev) for f in zip(*outs))
    return first


def _each_shard(mesh: FramesMesh, fns: list, shard_args: list):
    """fns[i](*shard_args[i]) on mesh.devices[i], each CUDA shard on a
    stream of its own; returns the outputs once every device's current
    stream has been made to wait for its shards."""
    streams = [_stream_on(d) for d in mesh.devices]
    outs = []
    for fn, s, args in zip(fns, streams, shard_args):
        ctx = (torch.cuda.stream(s) if s is not None
               else contextlib.nullcontext())
        with ctx:
            outs.append(fn(*args))
    for dev, s, out in zip(mesh.devices, streams, outs):
        if s is None:
            continue
        cur = torch.cuda.current_stream(dev)
        cur.wait_stream(s)
        for t in _tensors(out):
            if t.is_cuda:
                t.record_stream(cur)
    return outs


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _split_args(args, mesh: FramesMesh) -> list:
    """Per-shard argument tuples: Shards pass through, tensors of rank >=
    1 are split along dim 0 (as the reference constrains every such
    argument to the batch sharding), anything else goes to every shard."""
    cols = []
    for a in args:
        if isinstance(a, Shards):
            cols.append(list(a))
        elif torch.is_tensor(a) and a.ndim >= 1:
            cols.append(list(shard_batch(a, mesh)))
        else:
            cols.append([a] * mesh.size)
    return [tuple(c[i] for c in cols) for i in range(mesh.size)]


def _tensor_tree(x) -> bool:
    """Whether x holds tensors and None only (through tuples and lists):
    a compiled step's tensor argument."""
    if torch.is_tensor(x) or x is None:
        return True
    return isinstance(x, (tuple, list)) and all(map(_tensor_tree, x))


def _shard_step(fn: Callable):
    """fn as a step of (tensors, statics): statics ((position, value),
    ...) in ascending position, the tensors filling the other positions
    in order."""

    def step(tensors, statics):
        args = list(tensors)
        for i, v in statics:
            args.insert(i, v)
        return fn(*args)

    step.__qualname__ = f"shard of {getattr(fn, '__qualname__', fn)}"
    return step


def sharded_frame_pipeline(fn: Callable, mesh: FramesMesh,
                           axis: str = "frames"):
    """`fn` (operating on a batch, each frame independent of the others)
    run shard by shard on the mesh; the returned function takes Shards
    or batched tensors and returns fn's output tree with the shards'
    outputs concatenated in order on the mesh's first device.

    fn is compiled once per shard index (``run.steps``, one ``core.jit``
    step each). An argument that is not a tensor tree (tensors and None
    through tuples and lists) goes to every shard as a static argument of
    the step: it must be hashable (jit raises TypeError otherwise), and
    each value keys its own graph.
    """
    steps = [jit(_shard_step(fn), static_argnames=("statics",))
             for _ in mesh.devices]

    def run(*args):
        static = [not _tensor_tree(a) for a in args]
        statics = tuple((i, a) for i, a in enumerate(args) if static[i])
        shard_args = [(tuple(a for a, st in zip(per, static) if not st),
                       statics) for per in _split_args(args, mesh)]
        return _join(_each_shard(mesh, steps, shard_args), mesh.devices[0])

    run.steps = steps
    return run


def fuse_views_allgather(mesh: FramesMesh, axis: str = "frames"):
    """Returns f(points (B,N,3), valid (B,N)) -> (points per device,
    masks per device): every shard's views gathered in order into one
    (B*N,3) cloud and (B*N,) mask, copied to every device of the mesh
    (lists, one entry per mesh device)."""

    def fuse(pts, valid):
        shards = _split_args((pts, valid), mesh)
        ps = [s[0].reshape(-1, 3) for s in shards]
        vs = [s[1].reshape(-1) for s in shards]
        fused = [(torch.cat([p.to(d) for p in ps]),
                  torch.cat([v.to(d) for v in vs])) for d in mesh.devices]
        return [f[0] for f in fused], [f[1] for f in fused]

    return fuse


def batch_stats_psum(mesh: FramesMesh, axis: str = "frames"):
    """Returns f(values (B,), mask (B,)) -> (mean, count), 0-d float32
    tensors on the mesh's first device: each shard's masked sum and
    count on its device, then their sums."""

    def stats(v, m):
        def part(v, m):
            return torch.stack([torch.sum(torch.where(m, v, 0.0)),
                                torch.sum(m.to(torch.float32))])

        parts = _each_shard(mesh, [part] * mesh.size,
                            _split_args((v, m), mesh))
        s, c = torch.stack([p.to(mesh.devices[0]) for p in parts]).sum(0)
        return s / torch.clamp(c, min=1.0), c

    return stats
