"""The port's counterpart of ``jax.jit``: a step captured once per static
configuration as a CUDA graph, then replayed with one host call.

    step = jit(process_frames, static_argnames=("config",
                                                 "with_pointcloud"))
    out = step(rgbs, depths, K, config)        # tensors on the card

JAX compiles a jitted function once per argument shapes, dtypes and
static values and dispatches it as one device program. The port's steps
are static-shaped and make no host read, so their counterpart records
every launch of one call into a ``torch.cuda.CUDAGraph``:

* the cache key holds each tensor argument's shape, dtype and device
  (through nested tuples, lists and NamedTuples), which optional
  arguments are None, the static arguments' values and the grad and
  inference modes. A parameter left out of the call keeps its Python
  default, as under ``jax.jit``;
* an argument that is neither a tensor (nor None) nor static raises
  TypeError: its value would be baked into the graph. The outputs are
  tensors too. The exception are ``scalar_argnames``: a Python number
  there becomes a 0-d float32 tensor on the step's device, as JAX traces
  a Python scalar, so a new value replays the same graph; and
  ``array_argnames``: a numpy array there is copied to the step's device
  before the step (its dtype kept), as JAX transfers a host array, so a
  new camera replays the same graph and is never baked into it;
* on a CUDA device the first call for a key copies the inputs into
  static buffers, runs ``fn`` ``WARMUP`` times on a side stream (which
  fills the constant caches of ``core/consts.py``, builds the kernels
  and their launch plans), captures one graph and replays it. Later
  calls copy the inputs in, replay, and return fresh tensors (clones of
  the graph's outputs), so two queued calls never alias. The first call
  synchronises the device; a replay does not;
* a capture or a replay that fails raises RuntimeError naming ``fn``
  and the CUDA error. The eager step never runs in its place;
* a call made while a capture or its warm-up runs (a jitted step inside
  another's) runs ``fn`` inline, as a nested ``jax.jit`` inlines;
* on the CPU ``fn`` runs directly, and inside ``disable_jit()`` too;
* a kernel wrapper counts its launch calls in ``kernels._build.launches``
  as it always does, so the warm-up and the capture count and a replay
  adds nothing: a replay's kernels show in a ``torch.profiler`` trace;
* ``CAPTURES`` counts every capture (warm-up and recording) and its
  seconds on the host clock, per function, always; while a
  ``torch.profiler`` profile runs, a capture is the span ``jit.capture``
  and a replay (input copies, ``graph.replay()``, output clones) the
  span ``jit.replay`` (``utils.profiling.span``), each with the
  function's module and qualname as its ``fn``;
* a graph keeps alive every cached tensor it reads (``pin``: the
  constants of ``core/consts.py``, the detector's code tables), so a
  cache's eviction cannot free memory a replay reads. ``clear_caches``
  drops every graph of every compiled function, as ``jax.clear_caches``
  does; ``tag_families.set_active_codebook`` calls it, since a captured
  detector decodes with the table it was captured with;
* each key holds its graph's private memory pool until ``clear`` or
  ``clear_caches``: about the eager step's working set, 4.4 GB for the
  720p batch-16 ``process_frames`` (``chip_smoke.py``'s compiled phase
  reports it per graph).

Calls are ordered on the caller's current stream. A graph has one set
of static buffers, so a replay on another stream than the graph's last
one waits for that replay (and its output clones) to finish first.

``while_loop(cond_fn, body_fn, state, max_trips)`` is the counterpart of
``jax.lax.while_loop`` inside a compiled step, for a condition that stays
false once it is false. Outside a capture it is a Python loop that reads
the condition on the host before each trip. Inside one it records
``max_trips`` conditional (IF) nodes in sequence, each gated by the
condition computed on the device after the trip before it, so a replay
runs the trips the data needs and reads nothing on the host. With
``unroll=False`` it records one WHILE node instead, whose body (one trip,
captured once) runs again while the condition, computed at the body's
end, holds and fewer than ``max_trips`` trips ran: the form for a long
body (ICP's iteration, about 5,900 nodes at 1M points).
Conditional nodes need CUDA 12.4 or later, in the runtime and the
driver; the port records them through the CUDA runtime
(``kernels/csrc/graph_if.cu``), as PyTorch 2.11 has no Python API for
them.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import inspect
import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from repas_tpu_torch.utils.profiling import span

# eager calls before the capture; one fills every lazy cache of the port
WARMUP = 1

_JITTED = weakref.WeakSet()     # every compiled function, for clear_caches
# module.qualname -> (captures, seconds) of every compiled function's
# captures, warm-up included, since the process started (clear_caches
# keeps them)
CAPTURES = {}
_pinning = threading.local()    # .pins: what the running capture reads
_warming = threading.local()    # .on: a capture's eager warm-up runs
_disabled = threading.local()   # .on: inside disable_jit()


def pin(x):
    """Returns x; while a capture runs on this thread, its graph also
    keeps x alive. Caches whose tensors a step reads pin what they hand
    out."""
    pins = getattr(_pinning, "pins", None)
    if pins is not None:
        pins.append(x)
    return x


@contextlib.contextmanager
def disable_jit():
    """Every compiled step called inside (on this thread) runs its
    function eagerly, the counterpart of ``jax.disable_jit()``."""
    prev = getattr(_disabled, "on", False)
    _disabled.on = True
    try:
        yield
    finally:
        _disabled.on = prev


def clear_caches() -> None:
    """Drops every captured graph of every compiled function and its
    memory, the counterpart of ``jax.clear_caches()``."""
    for jitted in list(_JITTED):
        jitted.clear()


class _Leaf:
    """Marks a tensor's place in a flattened argument or output tree."""

    def __repr__(self):
        return "<tensor>"


_LEAF = _Leaf()


def _flatten(x, leaves: list, where: str):
    """The tree structure of x, appending its tensors to `leaves`; a leaf
    that is neither a tensor nor None raises TypeError naming `where`."""
    if torch.is_tensor(x):
        leaves.append(x)
        return _LEAF
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves, f"{where}[{i}]")
                               for i, v in enumerate(x)))
    raise TypeError(
        f"argument {where} of type {type(x).__name__} is neither a tensor "
        "nor static: pass a tensor, or name it in static_argnames")


def _unflatten(tree, leaves):
    """Rebuilds a tree from `_flatten`'s structure and an iterator of
    tensors."""
    if tree is _LEAF:
        return next(leaves)
    if tree is None:
        return None
    typ, items = tree
    vals = [_unflatten(t, leaves) for t in items]
    if typ in (tuple, list):
        return typ(vals)
    return typ(*vals)          # a NamedTuple


@dataclass
class _Graph:
    """One captured call: its static input and output buffers, the output
    structure, the cached objects it reads (``pin``), the event and
    stream of its last replay, its nodes at the top level and the nodes
    of each WHILE node's body."""
    graph: torch.cuda.CUDAGraph
    static_in: list
    out_tree: tuple
    static_out: list
    pins: list
    done: torch.cuda.Event
    stream: int | None = None
    nodes: int | None = None
    while_nodes: list | None = None


class Jitted:
    """``fn`` captured per key as a CUDA graph (see the module's
    docstring). ``graphs`` maps each key to its captured call."""

    def __init__(self, fn, static_argnames=(), scalar_argnames=(),
                 array_argnames=()):
        self.fn = fn
        self.name = getattr(fn, "__qualname__", repr(fn))
        # CAPTURES' key and the spans' fn: qualnames repeat across modules
        self.full_name = f"{getattr(fn, '__module__', None)}.{self.name}"
        self.signature = inspect.signature(fn)
        self.static_argnames = tuple(static_argnames)
        self.scalar_argnames = tuple(scalar_argnames)
        self.array_argnames = tuple(array_argnames)
        for what, names in (("static_argnames", self.static_argnames),
                            ("scalar_argnames", self.scalar_argnames),
                            ("array_argnames", self.array_argnames)):
            unknown = [n for n in names
                       if n not in self.signature.parameters]
            if unknown:
                raise ValueError(f"jit({self.name}): {what} {unknown} are "
                                 "not parameters of the function")
        self.graphs = {}
        self._streams = {}
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn)
        _JITTED.add(self)

    def _split(self, args, kwargs):
        """(bound arguments, the key, the tensor leaves, the device or
        None when no tensor was given, the scalar arguments given as
        Python numbers and the array arguments given as numpy arrays:
        they are not in the key)."""
        bound = self.signature.bind(*args, **kwargs)
        statics, trees, leaves, host = [], [], [], []
        for name, param in self.signature.parameters.items():
            value = bound.arguments.get(name, param.default)
            if (name in self.scalar_argnames and _is_number(value)) or (
                    name in self.array_argnames
                    and isinstance(value, np.ndarray)):
                host.append(name)
            elif name in self.static_argnames:
                try:
                    hash(value)
                except TypeError as e:
                    raise TypeError(f"jit({self.name}): static argument "
                                    f"{name} is not hashable: {e}") from e
                statics.append((name, value))
            elif name in bound.arguments or param.default is None:
                # an omitted None default keys as None passed
                trees.append((name, _flatten(bound.arguments.get(name),
                                             leaves, name)))
        devices = {t.device for t in leaves}
        if len(devices) > 1:
            raise ValueError(f"jit({self.name}): tensors on "
                             f"{sorted(map(str, devices))}; a compiled step "
                             "takes every tensor on one device")
        key = (tuple(trees), tuple(statics),
               tuple((tuple(t.shape), t.dtype, t.device) for t in leaves),
               torch.is_grad_enabled(), torch.is_inference_mode_enabled())
        return bound, key, leaves, (devices.pop() if devices else None), \
            host

    def key(self, *args, **kwargs):
        """The cache key of a call with these arguments (on the card: a
        scalar argument keys as a 0-d float32 tensor, an array argument
        as the tensor it is copied to)."""
        bound, key, _, dev, host = self._split(args, kwargs)
        if host and dev is not None:
            key = self._split(*self._to_device(bound, host, dev))[1]
        return key

    def __call__(self, *args, **kwargs):
        bound, key, leaves, dev, host = self._split(args, kwargs)
        if dev is None or dev.type != "cuda" or \
                torch.cuda.is_current_stream_capturing() or \
                getattr(_warming, "on", False) or \
                getattr(_disabled, "on", False):
            return self.fn(*args, **kwargs)
        if host:
            bound, key, leaves, dev, _ = self._split(
                *self._to_device(bound, host, dev))
        if any(t.requires_grad for t in leaves):
            raise ValueError(f"jit({self.name}): a captured step does not "
                             "differentiate; pass tensors without "
                             "requires_grad")
        with self._lock:
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(bound, leaves, dev)
            return self._replay(entry, leaves, dev)

    def _to_device(self, bound, names, dev):
        """(args, kwargs) of `bound` with its host values of `names` on
        `dev`: a Python number of `scalar_argnames` as a 0-d float32 tensor
        (filled on the device: no host copy), a numpy array of
        `array_argnames` copied there with its dtype."""
        params = bound.signature.parameters
        for name in names:
            value = bound.arguments.get(name, params[name].default)
            if name in self.scalar_argnames and _is_number(value):
                bound.arguments[name] = torch.full(
                    (), float(value), dtype=torch.float32, device=dev)
            else:
                bound.arguments[name] = torch.from_numpy(
                    np.ascontiguousarray(value)).to(dev)
        return bound.args, bound.kwargs

    def _call_with(self, bound, tensors):
        """fn on `bound`'s arguments with their tensors replaced, in
        order, by `tensors`."""
        it = iter(tensors)
        arguments = {}
        for name, value in bound.arguments.items():
            if name in self.static_argnames:
                arguments[name] = value
            else:
                arguments[name] = _unflatten(_flatten(value, [], name), it)
        b = inspect.BoundArguments(self.signature, arguments)
        return self.fn(*b.args, **b.kwargs)

    def _capture(self, bound, leaves, dev) -> _Graph:
        """Warms fn up and records its graph, counted in CAPTURES (the
        failed ones too) and spanned as ``jit.capture``."""
        t0 = time.perf_counter()
        try:
            with span("jit.capture", fn=self.full_name):
                return self._record(bound, leaves, dev)
        finally:
            n, sec = CAPTURES.get(self.full_name, (0, 0.0))
            CAPTURES[self.full_name] = (n + 1,
                                        sec + time.perf_counter() - t0)

    def _record(self, bound, leaves, dev) -> _Graph:
        static_in = [t.detach().clone() for t in leaves]
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        _warming.on = True
        try:
            with torch.cuda.stream(stream):
                for _ in range(WARMUP):
                    self._call_with(bound, static_in)
        finally:
            _warming.on = False
        cur.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        pins = _pinning.pins = []
        while_nodes = _pinning.while_nodes = []
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = self._call_with(bound, static_in)
                nodes = _capture_nodes(stream)
        except RuntimeError as e:
            # a failed capture_end leaves the side stream current and
            # bound to the graph's pool: give it up
            torch.cuda.set_stream(cur)
            del self._streams[dev]
            raise RuntimeError(f"jit({self.name}): CUDA graph capture "
                               f"failed: {e}") from e
        finally:
            _pinning.pins = _pinning.while_nodes = None
        static_out = []
        out_tree = _flatten(out, static_out, "output")
        return _Graph(graph, static_in, out_tree, static_out, pins,
                      torch.cuda.Event(), nodes=nodes,
                      while_nodes=while_nodes)

    def _replay(self, entry: _Graph, leaves, dev):
        cur = torch.cuda.current_stream(dev)
        try:
            with span("jit.replay", fn=self.full_name):
                if entry.stream not in (None, cur.cuda_stream):
                    # the static buffers are still read by the last replay
                    cur.wait_event(entry.done)
                for buf, t in zip(entry.static_in, leaves):
                    buf.copy_(t)
                entry.graph.replay()
                fresh = [t.clone() for t in entry.static_out]
                entry.done.record(cur)
                entry.stream = cur.cuda_stream
        except RuntimeError as e:
            raise RuntimeError(f"jit({self.name}): CUDA graph replay "
                               f"failed: {e}") from e
        return _unflatten(entry.out_tree, iter(fresh))

    def clear(self) -> None:
        """Drops every captured graph and its memory."""
        with self._lock:
            self.graphs.clear()


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def jit(fn, *, static_argnames=(), scalar_argnames=(),
        array_argnames=()) -> Jitted:
    """``fn`` compiled per static configuration: on CUDA tensors one CUDA
    graph per key, replayed; on the CPU ``fn`` itself (module
    docstring). A Python number passed for one of `scalar_argnames`
    becomes a 0-d float32 tensor on the card, as JAX traces it; a numpy
    array passed for one of `array_argnames` is copied to the card
    before the step, as JAX transfers it."""
    return Jitted(fn, static_argnames, scalar_argnames, array_argnames)


def _capture_nodes(stream: torch.cuda.Stream) -> int:
    """The nodes a capture on `stream` has recorded (top level)."""
    from repas_tpu_torch.kernels import _build

    n = ctypes.c_ulonglong(0)
    _build.check("repas_capture_nodes", _build.library().repas_capture_nodes(
        stream.cuda_stream, stream.device.index, ctypes.addressof(n)))
    return n.value


def _capturing(leaves) -> bool:
    """Whether a capture records the work on these tensors."""
    return any(t.is_cuda for t in leaves) and \
        torch.cuda.is_current_stream_capturing()


_body_streams = {}      # device -> the stream node bodies are captured from


def _body_stream(dev) -> torch.cuda.Stream:
    body = _body_streams.get(dev)
    if body is None:
        body = _body_streams[dev] = torch.cuda.Stream(dev)
    return body


@contextlib.contextmanager
def _if_node(pred: torch.Tensor, pool):
    """Work issued inside is recorded into the body of an IF node that
    the running capture adds after `pred` (a one-element bool tensor on
    the card): ``csrc/graph_if.cu``. The body's allocations come from
    `pool`, which the graph keeps alive."""
    from repas_tpu_torch.kernels import _build

    dev = pred.device
    body = _body_stream(dev)
    lib = _build.library()
    _build.check("repas_if_begin", lib.repas_if_begin(
        pred.reshape(()).data_ptr(), body.cuda_stream, dev.index,
        torch.cuda.current_stream(dev).cuda_stream))
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool.id)
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        torch._C._cuda_endAllocateToPool(dev.index, pool.id)
        torch._C._cuda_releasePool(dev.index, pool.id)
        _build.check("repas_if_end", lib.repas_if_end(body.cuda_stream,
                                                      dev.index))


@contextlib.contextmanager
def _while_node(cond, pool):
    """Work issued inside is recorded, once, into the body of a WHILE node
    that the running capture adds after cond() (a function returning a
    one-element bool tensor on the card); cond() is computed again as the
    body's last work, and a replay runs the body again while it holds:
    ``csrc/graph_if.cu``. The body's allocations come from `pool`, which
    the graph keeps alive."""
    from repas_tpu_torch.kernels import _build

    pred = cond().reshape(())
    dev = pred.device
    body = _body_stream(dev)
    lib = _build.library()
    handle = ctypes.c_ulonglong(0)
    _build.check("repas_while_begin", lib.repas_while_begin(
        pred.data_ptr(), body.cuda_stream, dev.index,
        torch.cuda.current_stream(dev).cuda_stream, ctypes.addressof(handle)))
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool.id)
    again = None
    try:
        with torch.cuda.stream(body):
            yield
            again = cond().reshape(())
    finally:
        torch._C._cuda_endAllocateToPool(dev.index, pool.id)
        torch._C._cuda_releasePool(dev.index, pool.id)
        if again is None:        # the body raised: end its capture only
            lib.repas_if_end(body.cuda_stream, dev.index)
        else:
            nodes = ctypes.c_ulonglong(0)
            _build.check("repas_while_end", lib.repas_while_end(
                again.data_ptr(), handle.value, body.cuda_stream,
                dev.index, ctypes.addressof(nodes)))
            counts = getattr(_pinning, "while_nodes", None)
            if counts is not None:
                counts.append(nodes.value)


def while_loop(cond_fn, body_fn, state, max_trips: int, on_test=None,
               unroll: bool = True):
    """``jax.lax.while_loop(cond_fn, body_fn, state)`` for at most
    `max_trips` trips of a condition that stays false once false.

    `state` is a tensor tree (tuples, lists, NamedTuples); body_fn(state)
    returns a tree of the same shapes and dtypes, and cond_fn(state) a
    one-element bool tensor. Returns the final state.

    * Outside a capture: reads cond_fn on the host before each trip
      (calling `on_test` each time) and raises RuntimeError if it still
      holds after `max_trips` trips. In a capture's eager warm-up the body
      first runs once on a copy of the state, whose result is dropped, so
      its lazy caches (kernel builds, constants, launch plans) are filled
      before the capture records it even where the loop runs no trip.
    * Inside a ``jit`` capture, `unroll` True: `max_trips` IF nodes,
      each gated by cond_fn of the state after the one before; each body
      writes its result into the state's own tensors (a skipped body
      leaves them), so the nodes after it read fixed addresses. The
      bodies are captured from one stream and allocate from one memory
      pool, which the graph keeps, so a body reuses the blocks the one
      before freed.
    * Inside a ``jit`` capture, `unroll` False: one WHILE node whose
      body, captured once, runs a trip, writes the state's own tensors,
      counts the trip on the device and computes cond_fn & (trips <
      max_trips) for the node to test: a replay runs the trips the data
      needs, at most `max_trips`, and reads nothing on the host.
    """
    leaves = []
    tree = _flatten(state, leaves, "state")

    def rebuild(ts):
        return _unflatten(tree, iter(ts))

    def flat(new):
        out = []
        if _flatten(new, out, "body output") != tree or any(
                (a.shape, a.dtype) != (b.shape, b.dtype)
                for a, b in zip(out, leaves)):
            raise ValueError("while_loop: the body changed the state's "
                             "structure, shapes or dtypes")
        return out

    if _capturing(leaves):
        if getattr(_pinning, "pins", None) is None:
            raise RuntimeError("while_loop: a capture records its trips "
                               "only inside a core.jit step")
        with torch.cuda.device(leaves[0].device):
            pool = pin(torch.cuda.MemPool())
        bufs = [t.clone() for t in leaves]
        if not unroll:
            trips = torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)

            def go():
                return cond_fn(rebuild(bufs)).reshape(()) & (trips
                                                              < max_trips)

            with _while_node(go, pool):
                for buf, t in zip(bufs, flat(body_fn(rebuild(bufs)))):
                    buf.copy_(t)
                trips.add_(1)
            return rebuild(bufs)
        for _ in range(max_trips):
            with _if_node(cond_fn(rebuild(bufs)), pool):
                for buf, t in zip(bufs, flat(body_fn(rebuild(bufs)))):
                    buf.copy_(t)
        return rebuild(bufs)

    if getattr(_warming, "on", False):
        flat(body_fn(rebuild([t.clone() for t in leaves])))
    for trip in range(max_trips + 1):
        if on_test is not None:
            on_test()
        if not bool(cond_fn(rebuild(leaves))):
            return rebuild(leaves)
        if trip == max_trips:
            raise RuntimeError(f"while_loop: the condition still holds "
                               f"after max_trips={max_trips} trips")
        leaves = flat(body_fn(rebuild(leaves)))
