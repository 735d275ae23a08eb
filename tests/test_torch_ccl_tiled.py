"""Kernel B4's plain versions (the segmented-scan unit and the tiled CCL)
and the size dispatch of ``connected_components``, against the JAX
package on the CPU.

Tolerance: exact. Labels are integers from min, compares and selects
only, and the fixed-round labels of unconverged components must match
too. The Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repas_tpu.kernels import ccl as JC  # noqa: E402
from repas_tpu.kernels.ccl_pallas import (  # noqa: E402
    _make_scan_kernel, connected_components_pallas_tiled)
from repas_tpu_torch.kernels import ccl, ccl_tiled  # noqa: E402


def _mask(seed, shape, density):
    return np.random.default_rng(seed).random(shape) > density


@pytest.mark.parametrize("iters", [1, 5])
def test_tiled_plain_matches_pallas_tiled_720p(iters):
    """The robust ladder's shape, through the reference's band grid."""
    m = _mask(iters, (720, 1280), 0.5)
    ref = np.asarray(connected_components_pallas_tiled(
        jnp.asarray(m), iters=iters, interpret=True))
    got = ccl_tiled.connected_components_tiled_plain(
        torch.from_numpy(m[None]), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), ref)
    # and B1's plain version gives the same labels
    np.testing.assert_array_equal(
        ccl.connected_components_plain(torch.from_numpy(m[None]),
                                       iters)[0].numpy(), ref)


def _ref_unit(mask, labels, axis):
    """The reference's B4 unit on one image, whole image as one block."""
    h, w = mask.shape
    return np.asarray(pl.pallas_call(
        _make_scan_kernel(axis, h * w),
        out_shape=jax.ShapeDtypeStruct((h, w), jnp.int32),
        interpret=True)(jnp.asarray(mask.astype(np.int32)),
                        jnp.asarray(labels)))


@pytest.mark.parametrize("dim,axis", [(2, 1), (1, 0), (-1, 1), (-2, 0)])
@pytest.mark.parametrize("density", [0.3, 0.6])
def test_seg_scan_axis_plain_on_any_labels(dim, axis, density):
    """Random labels, background ones and ones above the sentinel
    included: a background pixel starts its segment with its own label,
    and a segment open to the image edge also takes the sentinel."""
    B, h, w = 2, 37, 70
    m = _mask(7, (B, h, w), density)
    lab = np.random.default_rng(8).integers(0, 2 * h * w, (B, h, w)).astype(
        np.int32)
    got = ccl_tiled.seg_scan_axis_plain(torch.from_numpy(m),
                                        torch.from_numpy(lab), dim)
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(),
                                      _ref_unit(m[b], lab[b], axis))


def test_seg_scan_axis_rejects_batch_dim():
    m = torch.zeros((1, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        ccl_tiled.seg_scan_axis_plain(m, torch.zeros((1, 4, 4),
                                                     dtype=torch.int32), 0)


def test_connected_components_dispatches_by_size(monkeypatch):
    """Over MAX_VMEM_PIXELS a CPU mask takes the tiled plain version, at
    or under it B1's plain version; the labels agree either way."""
    assert ccl.MAX_VMEM_PIXELS == JC.MAX_VMEM_PIXELS
    calls = []
    tiled = ccl_tiled.connected_components_tiled_plain
    plain = ccl.connected_components_plain
    monkeypatch.setattr(ccl_tiled, "connected_components_tiled_plain",
                        lambda m, i, c: calls.append("tiled")
                        or tiled(m, i, c))
    monkeypatch.setattr(ccl, "connected_components_plain",
                        lambda m, i, c: calls.append("plain")
                        or plain(m, i, c))
    big = torch.from_numpy(_mask(9, (1, 725, 725), 0.7))   # 525,625 px
    small = torch.from_numpy(_mask(9, (1, 512, 1024), 0.7))  # 524,288 px
    got = ccl.connected_components(big, 2)
    assert calls == ["tiled"]
    assert torch.equal(got, plain(big, 2))
    ccl.connected_components(small, 2)
    assert calls == ["tiled", "plain"]
