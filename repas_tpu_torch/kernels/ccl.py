"""Connected-component labeling and top-K component selection.

Port of ``repas_tpu/kernels/ccl.py``: ``connected_components`` (dispatch
by size and device, with ``MAX_VMEM_PIXELS``),
its plain version (``_connected_components_xla`` with ``jump_every=0``),
``component_areas``, ``_component_runs``, ``component_bboxes`` and both
paths of ``top_k_components``. All functions
take a leading batch dimension: masks and labels are (B,H,W).

Labels are linear pixel indices; background pixels hold the sentinel
H*W. ``iters`` rounds of forward+backward segmented min-scans along rows,
then along columns, then an 8-neighbour min stencil. The result is the
fixed-iteration labelling, bit for bit: a component that has not
converged in ``iters`` rounds keeps the labels the reference gives it.

With ``converge=True`` the labels go on from ``iters`` rounds to the
rounds' fixed point (the card's kernels by more rounds, the plain
versions by hooks and jumps): every 8-connected component then carries
one label, its least linear index (the JAX package has no such mode).
Where the fixed-round labels had converged, the two are equal. The
detector asks for this: a tag's border ring turned in plane is a
staircase that each round walks only about one border width along, so
a large turned ring needs more rounds than an upright one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# images up to this many pixels go through B1, larger ones through the
# tiled B4, as the reference sends them to its one-block and band-tiled
# Pallas kernels (both kernels give the same labels)
MAX_VMEM_PIXELS = 512 * 1024


def connected_components(mask: torch.Tensor, iters: int = 5,
                         converge: bool = False) -> torch.Tensor:
    """8-connected labels of a (B,H,W) bool mask -> (B,H,W) int32:
    `iters` rounds, or with `converge` at least `iters` and then on to
    the fixed point.

    Up to MAX_VMEM_PIXELS per image, a CUDA tensor goes through kernel B1
    (ccl_cuda.py), above it through kernel B4 (ccl_tiled.py); a CPU
    tensor through the matching plain version.
    """
    if mask.shape[-2] * mask.shape[-1] > MAX_VMEM_PIXELS:
        from repas_tpu_torch.kernels.ccl_tiled import \
            connected_components_tiled
        return connected_components_tiled(mask, iters, converge)
    if mask.is_cuda:
        from repas_tpu_torch.kernels.ccl_cuda import connected_components_cuda
        return connected_components_cuda(mask, iters, converge)
    return connected_components_plain(mask, iters, converge)


def _seg_min_scan(lab: torch.Tensor, brk: torch.Tensor, dim: int,
                  reverse: bool, sentinel: int) -> torch.Tensor:
    """Inclusive segmented min-scan along `dim` (a break flag resets the
    running min), by Hillis-Steele doubling of the reference's combine
    ``(bb ? bv : min(av, bv), ab | bb)``: min is exact and associative,
    so the doubling gives the reference's scan bit for bit."""
    n = lab.shape[dim]
    v, b = lab, brk
    d = 1
    while d < n:
        pad = [0, 0] * (lab.ndim - 1 - (dim % lab.ndim))
        pad += [0, d] if reverse else [d, 0]
        if reverse:
            vs = F.pad(v.narrow(dim, d, n - d), pad, value=sentinel)
            bs = F.pad(b.narrow(dim, d, n - d), pad, value=False)
        else:
            vs = F.pad(v.narrow(dim, 0, n - d), pad, value=sentinel)
            bs = F.pad(b.narrow(dim, 0, n - d), pad, value=False)
        v = torch.where(b, v, torch.minimum(v, vs))
        b = b | bs
        d *= 2
    return v


def _neighbor_min(lab: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Min over the 3x3 neighbourhood, out of bounds = sentinel."""
    h, w = lab.shape[-2:]
    p = F.pad(lab, (1, 1, 1, 1), value=sentinel)
    m = lab
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = torch.minimum(m, p[..., 1 + dy:1 + dy + h,
                                       1 + dx:1 + dx + w])
    return m


def initial_labels(mask: torch.Tensor) -> torch.Tensor:
    """Each foreground pixel's linear index, the sentinel H*W elsewhere."""
    h, w = mask.shape[-2:]
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=mask.device).reshape(h, w)
    return torch.where(mask, idx, h * w)


def _jump(labels: torch.Tensor) -> torch.Tensor:
    """Each label replaced by the label of the pixel it names, again until
    none changes. A label is always the index of a pixel of its own
    component, so this only walks the labels down their chains inside
    each component (the sentinel names no pixel and stays)."""
    flat = labels.reshape(labels.shape[0], -1).to(torch.int64)
    while True:
        nxt = torch.gather(F.pad(flat, (0, 1), value=flat.shape[1]), 1,
                           flat)
        if torch.equal(nxt, flat):
            return nxt.reshape(labels.shape).to(labels.dtype)
        flat = nxt


def _hook(labels: torch.Tensor) -> torch.Tensor:
    """The converged labels from labels that each name a pixel of their
    own component: jump along the label chains (``_jump``), then hook
    each root that has a smaller root among its 8 neighbours onto the
    least of them, until no root has (host reads: the plain versions).
    A hook merges whole fragments at once, where a round moves a label
    along a staircase about one border width."""
    B = labels.shape[0]
    sentinel = labels.shape[-2] * labels.shape[-1]
    fg = labels != sentinel
    while True:
        labels = _jump(labels)
        m = torch.where(fg, _neighbor_min(labels, sentinel), sentinel)
        if not bool(torch.any(m < labels)):
            return labels
        roots = F.pad(labels.reshape(B, -1).to(torch.int64), (0, 1),
                      value=sentinel)
        least = F.pad(m.reshape(B, -1).to(torch.int64), (0, 1),
                      value=sentinel)
        roots = roots.scatter_reduce(1, roots, least, "amin")
        labels = roots[:, :sentinel].reshape(labels.shape).to(labels.dtype)


def run_rounds(round_fn, labels: torch.Tensor, iters: int,
               converge: bool) -> torch.Tensor:
    """`iters` rounds of `round_fn`; with `converge`, then on to the
    fixed point of the rounds by hooks and jumps (``_hook``). A fixed
    point gives each component one label, and the only label it can
    hold is its least index: the converged labels are the same whatever
    reaches them, and hooks take the CPU there in a few passes where the
    card's kernel runs more rounds."""
    for _ in range(iters):
        labels = round_fn(labels)
    return _hook(labels) if converge else labels


def connected_components_plain(mask: torch.Tensor, iters: int = 5,
                               converge: bool = False) -> torch.Tensor:
    """Plain PyTorch CCL: the spec the CUDA kernel is held to."""
    sentinel = mask.shape[-2] * mask.shape[-1]
    brk = ~mask

    def one_round(labels):
        for dim in (2, 1):
            for reverse in (False, True):
                labels = torch.where(
                    mask, _seg_min_scan(labels, brk, dim, reverse, sentinel),
                    sentinel)
        return torch.where(mask, _neighbor_min(labels, sentinel), sentinel)

    return run_rounds(one_round, initial_labels(mask), iters, converge)


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """Pixel count per label: (...,H,W) labels -> (...,H*W) float32, the
    reference's scatter-add of ones into H*W+1 bins (the last one, the
    background sentinel's, dropped)."""
    h, w = labels.shape[-2:]
    n = h * w
    flat = labels.reshape(*labels.shape[:-2], n).to(torch.int64)
    out = torch.zeros(*flat.shape[:-1], n + 1, dtype=torch.float32,
                      device=labels.device)
    return out.scatter_add_(-1, flat, torch.ones_like(flat, dtype=out.dtype)
                            )[..., :n]


def component_bboxes(labels: torch.Tensor):
    """Per-label bounding boxes by scatter-min/max of the pixel
    coordinates: (...,H,W) labels -> (xmin, xmax, ymin, ymax), each
    (...,H*W) float32, +inf (mins) and -inf (maxes) where a label is
    absent."""
    h, w = labels.shape[-2:]
    n = h * w
    flat = labels.reshape(*labels.shape[:-2], n).to(torch.int64)
    dev = labels.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xs, ys = xs.expand(flat.shape), ys.expand(flat.shape)

    def scatter(src, op, fill):
        out = torch.full((*flat.shape[:-1], n + 1), fill, dtype=torch.float32,
                         device=dev)
        return out.scatter_reduce_(-1, flat, src, op)[..., :n]

    inf = float("inf")
    return (scatter(xs, "amin", inf), scatter(xs, "amax", -inf),
            scatter(ys, "amin", inf), scatter(ys, "amax", -inf))


def _component_runs(flat: torch.Tensor, sentinel: int):
    """Exact per-component areas without a scatter: sort the (...,N) label
    arrays and count run lengths with a reverse min-scan over run starts.

    Returns (run_label (...,N), run_area (...,N) f32): nonzero area only
    at run-start positions; background (sentinel) runs get area 0."""
    n = flat.shape[-1]
    s = torch.sort(flat, dim=-1).values
    pos = torch.arange(n, dtype=torch.int32, device=flat.device)
    is_start = torch.ones_like(s, dtype=torch.bool)
    is_start[..., 1:] = s[..., 1:] != s[..., :-1]
    sp = torch.where(is_start, pos, n)
    nxt_incl = torch.flip(torch.cummin(torch.flip(sp, (-1,)), dim=-1).values,
                          (-1,))
    nxt = torch.cat([nxt_incl[..., 1:],
                     torch.full_like(nxt_incl[..., :1], n)], dim=-1)
    area = torch.where(is_start & (s < sentinel),
                       (nxt - pos).to(torch.float32), 0.0)
    return s, area


def top_k_stable(x: torch.Tensor, k: int):
    """lax.top_k semantics along the last dim: descending, ties broken
    toward the lower index (torch.topk does not promise that order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_components(labels: torch.Tensor, k: int, min_area: float = 1.0,
                     max_area: float = float("inf"),
                     ring_filter: bool = False, min_side: float = 8.0,
                     return_bbox: bool = False):
    """Select the k largest components per frame of (B,H,W) labels.

    With ring_filter, the 2k largest area-gated components of a stride-2
    subsample are screened by quad-border plausibility (bbox fill ratio in
    (0.1, 0.95), aspect in (0.2, 5), sides >= min_side).

    Returns (root_labels (B,k) int32, areas (B,k) f32, valid (B,k) bool),
    and with return_bbox (ring path only) a (B,k,4) f32
    [xmin, ymin, xmax, ymax] stride-2 bbox per slot.
    """
    B, h, w = labels.shape
    if not ring_filter:
        run_label, run_area = _component_runs(labels.reshape(B, -1),
                                              sentinel=h * w)
        ok = (run_area >= min_area) & (run_area <= max_area)
        scored = torch.where(ok, run_area, 0.0)
        top_areas, top_pos = top_k_stable(scored, k)
        roots = torch.gather(run_label, 1, top_pos).to(torch.int32)
        return roots, top_areas, top_areas > 0

    lab2 = labels[:, ::2, ::2]
    h2, w2 = lab2.shape[-2:]
    flat2 = lab2.reshape(B, -1)
    run_label, run_area = _component_runs(flat2, sentinel=h * w)
    run_area = run_area * 4.0
    ok = (run_area >= min_area) & (run_area <= max_area)
    scored = torch.where(ok, run_area, 0.0)
    cand_areas, cand_pos = top_k_stable(scored, 2 * k)
    cand_idx = torch.gather(run_label, 1, cand_pos).to(torch.int32)
    m = flat2[:, None, :] == cand_idx[:, :, None]              # (B,2k,N/4)
    dev = labels.device
    xs = 2.0 * torch.arange(w2, dtype=torch.float32,
                            device=dev).repeat(h2)
    ys = 2.0 * torch.arange(h2, dtype=torch.float32,
                            device=dev).repeat_interleave(w2)
    big = 1e9
    # the root pixel (label = min row-major index) is always a member
    x_root = (cand_idx % w).to(torch.float32)
    y_root = (cand_idx // w).to(torch.float32)
    xmin = torch.minimum(torch.amin(torch.where(m, xs, big), dim=-1), x_root)
    xmax = torch.maximum(torch.amax(torch.where(m, xs, -big), dim=-1), x_root)
    ymin = torch.minimum(torch.amin(torch.where(m, ys, big), dim=-1), y_root)
    ymax = torch.maximum(torch.amax(torch.where(m, ys, -big), dim=-1), y_root)
    bw = xmax - xmin + 2.0
    bh = ymax - ymin + 2.0
    fill = cand_areas / torch.clamp(bw * bh, min=1.0)
    aspect = bw / torch.clamp(bh, min=1.0)
    ring_ok = ((cand_areas > 0) & (fill > 0.10) & (fill < 0.95)
               & (aspect > 0.2) & (aspect < 5.0)
               & (bw >= min_side) & (bh >= min_side))
    final_scores, final_slots = top_k_stable(
        torch.where(ring_ok, cand_areas, 0.0), k)
    out = (torch.gather(cand_idx, 1, final_slots), final_scores,
           final_scores > 0)
    if return_bbox:
        bbox = torch.stack([xmin, ymin, xmax, ymax], dim=-1)
        out = out + (torch.gather(bbox, 1, final_slots[..., None]
                                  .expand(-1, -1, 4)),)
    return out
