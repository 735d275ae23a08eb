"""Kernel B2's plain version and the window geometry against the JAX
package's non-TPU path (vmapped dynamic_slice of the same windows).

Tolerance: exact (patches, origins).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.kernels import patch_extract as J  # noqa: E402
from repas_tpu_torch.kernels import patch_extract as T  # noqa: E402


def _case(seed, shape, ph, pw, n):
    rng = np.random.default_rng(seed)
    B, hp, w = shape
    pyr = (rng.random(shape) * 255).astype(np.float32)
    pyr_bf = np.asarray(jnp.asarray(pyr).astype(jnp.bfloat16))
    y0 = rng.integers(0, hp - ph + 1, (B, n)).astype(np.int32)
    x0 = rng.integers(0, w - pw + 1, (B, n)).astype(np.int32)
    return pyr_bf, y0, x0


@pytest.mark.parametrize("shape,ph,pw,aligned", [
    ((2, 416, 640), 192, 192, True),     # the main path's geometry
    ((2, 100, 150), 64, 48, False),      # degraded exact windows
])
def test_extract_patches_pyramid_exact(shape, ph, pw, aligned):
    pyr, y0, x0 = _case(0, shape, ph, pw, 5)
    assert T.aligned_ok(shape, ph, pw) == J.aligned_ok(shape[1:], ph, pw) \
        == aligned
    pj, ayj, axj = jax.vmap(
        lambda p, y, x: J.extract_patches_pyramid(p, y, x, ph, pw))(
        jnp.asarray(pyr), jnp.asarray(y0), jnp.asarray(x0))
    pt, ayt, axt = T.extract_patches_pyramid(
        torch.from_numpy(np.asarray(pyr).view(np.uint16).copy()).view(
            torch.bfloat16), torch.from_numpy(y0), torch.from_numpy(x0),
        ph, pw)
    assert pt.dtype == torch.bfloat16
    np.testing.assert_array_equal(pt.view(torch.int16).numpy(),
                                  np.asarray(pj).view(np.int16))
    np.testing.assert_array_equal(ayt.numpy(), np.asarray(ayj))
    np.testing.assert_array_equal(axt.numpy(), np.asarray(axj))


def test_extract_windows_plain_clamps_like_dynamic_slice():
    # origins past the edge clamp so the window fits (negative origins
    # count from the end: tests/test_torch_window_starts.py)
    pyr = torch.arange(2 * 20 * 30, dtype=torch.float32).reshape(2, 20, 30)
    origins = torch.tensor([[[0, 0], [18, 29]], [[3, 4], [100, 0]]],
                           dtype=torch.int32)
    got = T.extract_windows_plain(pyr, origins, 6, 8)
    for b in range(2):
        for c in range(2):
            y, x = origins[b, c].tolist()
            ref = jax.lax.dynamic_slice(jnp.asarray(pyr[b].numpy()),
                                        (y, x), (6, 8))
            np.testing.assert_array_equal(got[b, c].numpy(),
                                          np.asarray(ref))
