"""The converged connected-component labels (``converge=True``) of the
port's CPU routes against a plain reference written here, which imports
nothing of the port's kernels.

The reference labels each 8-connected component of a mask with its least
linear index by min-propagation: every foreground pixel takes the least
label of its 3x3 neighbourhood, then the label of the pixel its label
names (a jump along the chain of labels, which never leaves the
component), repeated until nothing changes. At that point neighbouring
foreground pixels share a label, and the only label a component can
hold is its least index.

Routes: ``connected_components_plain`` and ``connected_components``
(B1's CPU dispatch), ``connected_components_tiled_plain`` (B4's), at
several least round counts, on seeded random masks and on rendered
square rings turned in plane (the shape that fixed rounds leave split).
Tolerance: exact (integer labels). Also: where the fixed-round labels
have converged, the converged ones equal them.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repas_tpu_torch.kernels import ccl, ccl_tiled
from torch_threads import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def reference_labels(mask: torch.Tensor) -> torch.Tensor:
    """(B,H,W) bool -> (B,H,W) int32: each 8-connected component's least
    linear index, the sentinel H*W on background."""
    B, h, w = mask.shape
    sent = h * w
    idx = torch.arange(h * w, dtype=torch.int64).reshape(h, w)
    lab = torch.where(mask, idx, sent)
    while True:
        p = F.pad(lab, (1, 1, 1, 1), value=sent)
        m = torch.stack([p[:, dy:dy + h, dx:dx + w] for dy in range(3)
                         for dx in range(3)]).amin(0)
        m = torch.where(mask, m, sent)
        # jump: the label of the pixel that the label names
        flat = torch.cat([m.reshape(B, -1),
                          torch.full((B, 1), sent)], dim=1)
        m = torch.where(mask, torch.gather(flat, 1, m.reshape(B, -1))
                        .reshape(B, h, w), sent)
        if torch.equal(m, lab):
            return lab.to(torch.int32)
        lab = m


def turned_rings(shape, side, width, turns, seed=0):
    """A (len(turns), H, W) mask of square rings of outer side `side` and
    border `width` px, turned by each of `turns` degrees about a
    seeded centre near the image's, with a little seeded speckle."""
    h, w = shape
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for deg in turns:
        a = np.radians(deg)
        cx, cy = w / 2 + rng.uniform(-3, 3), h / 2 + rng.uniform(-3, 3)
        u = (xs - cx) * np.cos(a) + (ys - cy) * np.sin(a)
        v = -(xs - cx) * np.sin(a) + (ys - cy) * np.cos(a)
        r = np.maximum(np.abs(u), np.abs(v))
        ring = (r <= side / 2) & (r > side / 2 - width)
        out.append(ring | (rng.random((h, w)) < 0.02))
    return torch.from_numpy(np.stack(out))


ROUTES = {
    "plain": ccl.connected_components_plain,
    "dispatch": ccl.connected_components,
    "tiled_plain": ccl_tiled.connected_components_tiled_plain,
}


def test_reference_on_a_known_mask():
    m = torch.zeros((1, 5, 7), dtype=torch.bool)
    m[0, 0, 1] = m[0, 1, 2] = m[0, 2, 2] = True     # one diagonal chain
    m[0, 4, 0] = m[0, 4, 6] = True                   # two singletons
    lab = reference_labels(m)[0]
    assert lab[0, 1] == lab[1, 2] == lab[2, 2] == 1
    assert lab[4, 0] == 28 and lab[4, 6] == 34
    assert (lab[~m[0]] == 35).all()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("seed,density,iters", [
    (0, 0.45, 5), (1, 0.55, 1), (2, 0.35, 2), (3, 0.6, 5)])
def test_converged_routes_match_reference_on_random_masks(route, seed,
                                                          density, iters):
    masks = torch.from_numpy(
        np.random.default_rng(seed).random((2, 48, 80)) >= density)
    got = ROUTES[route](masks, iters, converge=True)
    assert got.dtype == torch.int32
    assert torch.equal(got, reference_labels(masks))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_converged_routes_match_reference_on_turned_rings(route):
    rings = turned_rings((160, 176), 110, 9, [15, 22.5, 35, 45])
    ref = reference_labels(rings)
    got = ROUTES[route](rings, 5, converge=True)
    assert torch.equal(got, ref)
    # five fixed rounds leave some of these rings split: the case the
    # converged labels exist for
    fixed = ROUTES[route](rings, 5)
    assert not torch.equal(fixed, ref)


def test_converged_equals_fixed_rounds_where_those_converged():
    masks = torch.from_numpy(
        np.random.default_rng(7).random((2, 40, 64)) >= 0.5)
    ref = reference_labels(masks)
    n = 1
    while not torch.equal(ccl.connected_components_plain(masks, n), ref):
        n += 1
    for iters in (n, n + 3):
        assert torch.equal(ccl.connected_components_plain(masks, iters), ref)
        assert torch.equal(
            ccl.connected_components_plain(masks, iters, converge=True), ref)
