"""The port's FPFH features, feature matching and batched RANSAC
(``cloud/fpfh.py``) against the JAX package on the CPU.

Tolerances: FPFH rows within 1e-4 except where a Darboux angle within an
ulp of a bin edge fell into the other bin (XLA contracts the frame's
products into FMAs): at most 1 % of the rows, each within 0.5 of the
reference (one count moved between neighbouring bins, weighted by
1/(cnt * distance)). Matches equal wherever the best target beats the
runner-up by more than 1e-3 in squared feature distance (measured gaps
of d2 between the two sides: a few 1e-3 at |d2| ~ 1e4). RANSAC is
compared on the picks and evaluation points the reference's
``jax.random.choice`` draws: every hypothesis's score equal, the best
index equal, T within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.cloud import fpfh as J  # noqa: E402
from repas_tpu.cloud.filters import (compact_masked,  # noqa: E402
                                     voxel_downsample)
from repas_tpu.cloud.normals import estimate_normals_grid  # noqa: E402
from repas_tpu.core.transforms import rodrigues  # noqa: E402
from repas_tpu_torch.cloud import fpfh as T  # noqa: E402


def _bumpy(rng, n):
    pts = np.column_stack([rng.uniform(-0.5, 0.5, n),
                           rng.uniform(-0.5, 0.5, n),
                           np.zeros(n)]).astype(np.float32)
    pts[:, 2] = (0.08 * np.sin(7 * pts[:, 0]) * np.cos(5 * pts[:, 1])
                 + 0.05 * pts[:, 0] ** 2)
    return pts


def _pair(seed, n):
    rng = np.random.default_rng(seed)
    tgt = _bumpy(rng, n)
    R = np.asarray(rodrigues(jnp.asarray(np.array([0.05, -0.08, 0.35],
                                                  np.float32))))
    t = np.array([0.08, -0.05, 0.04], np.float32)
    return ((tgt - t) @ R).astype(np.float32), tgt


def _voxel_cloud(pts, voxel=0.03, capacity=2048):
    """The registration recipe's input to FPFH: downsampled, compacted."""
    pd, _, _, md = voxel_downsample(jnp.asarray(pts),
                                    jnp.ones(len(pts), bool), voxel)
    pc, mc, _ = compact_masked(pd, md, capacity)
    return np.array(pc), np.array(mc)


def _features(pts, mask, radius, k, nrm_radius, **kw):
    nrm, _ = estimate_normals_grid(jnp.asarray(pts), jnp.asarray(mask), k=16,
                                   radius=nrm_radius, **kw)
    nrm = np.array(nrm)
    fj = np.array(J.fpfh_features(jnp.asarray(pts), jnp.asarray(nrm),
                                  jnp.asarray(mask), radius=radius, k=k,
                                  **kw))
    ft = T.fpfh_features(*(torch.from_numpy(a) for a in (pts, nrm, mask)),
                         radius=radius, k=k, **kw).numpy()
    return fj, ft


@pytest.mark.parametrize("case", ["dense", "voxel"])
def test_fpfh_features_match_reference(case):
    src, _ = _pair(0, 1500 if case == "dense" else 30000)
    if case == "dense":
        pts, mask = src, np.ones(len(src), bool)
        fj, ft = _features(pts, mask, 0.15, 32, 0.08)
    else:
        pts, mask = _voxel_cloud(src)
        kw = dict(dims=(32, 32, 32), slots=32)
        fj, ft = _features(pts, mask, 5 * 0.03, 48, 2 * 0.03, **kw)
    err = np.abs(ft - fj).max(axis=1)
    moved = err > 1e-4
    assert moved.mean() <= 0.01, (moved.mean(), err.max())
    assert err.max() <= 0.5, err.max()
    assert (np.abs(fj).sum(axis=1)[mask] > 0).all()
    assert (ft[~mask] == 0).all()


def test_fpfh_chunks_do_not_change_the_result():
    pts, _ = _pair(1, 900)
    mask = np.ones(900, bool)
    nrm = np.array(estimate_normals_grid(jnp.asarray(pts), jnp.asarray(mask),
                                         k=16, radius=0.08)[0])
    args = [torch.from_numpy(a) for a in (pts, nrm, mask)]
    whole = T.fpfh_features(*args, radius=0.08, k=16)
    parts = T.fpfh_features(*args, radius=0.08, k=16, chunk=191)
    assert torch.equal(whole, parts)


def _matched(seed, n=1500):
    src, tgt = _pair(seed, n)
    mask = np.ones(n, bool)
    fs, _ = _features(src, mask, 0.15, 32, 0.08)
    ft, _ = _features(tgt, mask, 0.15, 32, 0.08)
    return src, tgt, mask, fs, ft


def test_match_features_matches_reference():
    src, tgt, mask, fs, ft = _matched(2)
    smask = mask.copy()
    smask[::7] = False
    tmask = mask.copy()
    tmask[::5] = False
    cj, dj = J.match_features(jnp.asarray(fs), jnp.asarray(smask),
                              jnp.asarray(ft), jnp.asarray(tmask), chunk=256)
    ct, dt = T.match_features(*(torch.from_numpy(a) for a in
                                (fs, smask, ft, tmask)), chunk=256)
    cj, ct = np.asarray(cj), ct.numpy()
    d2 = ((fs[:, None, :] - ft[None, :, :]) ** 2).sum(-1)
    d2[:, ~tmask] = np.inf
    two = np.sort(d2, axis=1)[:, :2]
    clear = smask & (two[:, 1] - two[:, 0] > 1e-3)
    assert clear[smask].mean() > 0.9
    np.testing.assert_array_equal(ct[clear], cj[clear])
    np.testing.assert_array_equal(ct[~smask], -1)
    np.testing.assert_allclose(dt.numpy()[clear], np.asarray(dj)[clear],
                               rtol=1e-5, atol=1e-2)


def _jax_scores(src, ok, tgt, corr, picks, ev, thresh, edge_check):
    """The reference's per-hypothesis scores (ransac_registration's
    hypothesis body, vmapped), which its public function does not
    return."""
    src, tgt = jnp.asarray(src), jnp.asarray(tgt)
    corr = jnp.asarray(corr)
    ok = jnp.asarray(ok)
    ev_src = src[ev]
    ev_tgt = tgt[jnp.maximum(corr[ev], 0)]
    ev_ok = ok[ev]

    def hyp(pick):
        P = src[pick]
        Q = tgt[jnp.maximum(corr[pick], 0)]
        eP = jnp.linalg.norm(P - jnp.roll(P, 1, axis=0), axis=1)
        eQ = jnp.linalg.norm(Q - jnp.roll(Q, 1, axis=0), axis=1)
        ratio = jnp.minimum(eP, eQ) / jnp.maximum(jnp.maximum(eP, eQ), 1e-12)
        R, t = J._kabsch(P, Q)
        d = jnp.linalg.norm(ev_src @ R.T + t - ev_tgt, axis=1)
        inl = jnp.sum((d <= thresh) & ev_ok)
        return jnp.where(jnp.all(ratio > edge_check), inl, -1)

    return np.asarray(jax.jit(jax.vmap(hyp))(jnp.asarray(picks)))


@pytest.mark.parametrize("seed,n_hyp", [(3, 4096), (4, 1024)])
def test_ransac_on_reference_picks_matches_reference(seed, n_hyp):
    src, tgt, mask, fs, ft = _matched(seed)
    corr = np.asarray(J.match_features(jnp.asarray(fs), jnp.asarray(mask),
                                       jnp.asarray(ft), jnp.asarray(mask))[0])
    key = jax.random.PRNGKey(seed)
    Tj, fitj = J.ransac_registration(jnp.asarray(src), jnp.asarray(mask),
                                     jnp.asarray(tgt), jnp.asarray(mask),
                                     jnp.asarray(corr), dist_thresh=0.03,
                                     n_hypotheses=n_hyp, key=key)
    # the reference's draws (ransac_registration's own split and choice)
    ok = mask & (corr >= 0)
    probs = jnp.asarray(ok, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    k1, k2 = jax.random.split(key)
    picks = np.array(jax.random.choice(k1, len(src), shape=(n_hyp, 3),
                                       p=probs))
    ev = np.array(jax.random.choice(k2, len(src), shape=(2048,), p=probs))
    Tt, fitt, scores, best = T._ransac_from_picks(
        *(torch.from_numpy(a) for a in (src, mask, tgt, mask, corr)), 0.03,
        0.9, torch.from_numpy(picks).long(), torch.from_numpy(ev).long())
    sj = _jax_scores(src, ok, tgt, corr, picks, ev, 0.03, 0.9)
    np.testing.assert_array_equal(scores.numpy(), sj)
    assert int(best) == int(np.argmax(sj))
    assert float(fitt) == float(fitj) and float(fitj) > 0.5
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-5)
    # the port's own draw recovers the pose as well
    Tp, fitp = T.ransac_registration(
        *(torch.from_numpy(a) for a in (src, mask, tgt, mask, corr)),
        dist_thresh=0.03, n_hypotheses=n_hyp, key=seed)
    assert float(fitp) > 0.5
    assert np.abs(Tp.numpy()[:3, 3] - np.asarray(Tj)[:3, 3]).max() < 0.02
