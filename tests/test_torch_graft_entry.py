"""The port's entry points (repas_tpu_torch.graft_entry) against the JAX
package's (__graft_entry__), on the CPU.

Tolerances (tests/test_torch_pipeline.py's 720p gates, but the corners):
  * the example frame (detect.render.example_frame, which both entry
    points use) against __graft_entry__._example_frame: bit for bit at
    (720, 1280) and (96, 128);
  * entry(): ids and valid slots equal; R_avg within 0.01 degrees;
    anchor_P_depth within 1e-4 m; the point cloud within rtol 1e-6, atol
    1e-9 (measured: 0 degrees, 0 m, 3e-8 m). Corners within 1e-2 px,
    but the x of the two right-hand corners (slots 1 and 2), held within
    0.42 px: entry()'s frame is noiseless, its right step edge ties
    between the refiner's offsets (ROADMAP C1), and the last bit of the
    line fit's weighted mean (XLA's summation order against torch's)
    decides the tie. Measured 0.4164 px on those two x values, every
    other coordinate equal; the noisy bench frame at 720p meets 1e-2 px
    everywhere (test_torch_pipeline.py).
  * dryrun_multichip(n), n = 2 and 4: the printed line equal character
    for character (conftest's 8-device CPU mesh runs the JAX dry run in
    this process), and the returned count and fused shape equal to the
    JAX run's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import __graft_entry__ as jge  # noqa: E402
from repas_tpu_torch import graft_entry  # noqa: E402
from repas_tpu_torch.detect.render import example_frame  # noqa: E402


def _angle_deg(Ra, Rb):
    Rr = np.swapaxes(Ra, -1, -2) @ Rb
    c = np.clip((np.trace(Rr, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


@pytest.mark.parametrize("shape", [(720, 1280), (96, 128)])
def test_example_frame_bit_for_bit(shape):
    for a, b in zip(example_frame(*shape), jge._example_frame(*shape)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_entry_matches_reference():
    jfn, jargs = jge.entry()
    ref = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    fn, args = graft_entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = [x.numpy() for x in fn(*args)]
    ids, corners, R_avg, anchor, pc = got
    np.testing.assert_array_equal(ids, ref[0])
    v = ids >= 0
    assert ids[v].tolist() == [9]
    err = np.abs(corners - ref[1])[v]            # (n, 4 corners, xy)
    tied = np.zeros(err.shape, bool)
    tied[:, [1, 2], 0] = True                    # the right edge's x
    assert err[~tied].max() <= 1e-2
    assert err[tied].max() <= 0.42
    assert _angle_deg(R_avg.astype(np.float64),
                      ref[2].astype(np.float64)) <= 0.01
    np.testing.assert_allclose(anchor, ref[3], atol=1e-4)
    assert pc.shape == ref[4].shape == (6, 720 * 1280)
    np.testing.assert_allclose(pc, ref[4], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_line(n, capsys):
    assert len(jax.devices()) >= n   # the CPU mesh is up: runs in process
    jge.dryrun_multichip(n)
    ref = capsys.readouterr().out.strip().splitlines()[-1]
    res = graft_entry.dryrun_multichip(n, devices=["cpu"] * n)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == ref
    assert ref.startswith(f"[dryrun_multichip] n_devices={n} frames={n} ")
    assert f"count={res['count']}" in ref
    assert f"fused_pts={res['fused_pts']}" in ref
    assert res["fused_pts"] == (n * 96 * 128, 3) and res["count"] == n


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
