"""The JAX package's detector with the port's two departures applied: the
reference for tests that hold the port's detector outputs against the
JAX package on the CPU.

The port's detector (``repas_tpu_torch/detect/detector.py``) departs from
the JAX package in two documented ways, so that tags turned in plane
decode at any angle: its connected-component labels run to their fixed
point (``ccl_iters`` is the least number of rounds), and a support point
no longer lands outside its component where a slanted edge ties (among
candidates tied for a direction's maximum, the JAX package's largest x
and largest y where that point is a tied candidate or the tied
candidates span at most one pixel of the window's level, else the tied
candidate farthest along the direction turned +90 degrees).
``applied()`` runs the JAX package's
detector with the same two rules, written here in jnp apart from the
port's code; the JAX package itself is not edited. Where the JAX
package's own labels had converged and its support points were members,
its outputs do not change. The rules themselves are held to the drawn
corners (``test_torch_detector_turns.py``) and to a plain converged
labelling (``test_torch_ccl_converged.py``).

A test module takes the reference so by importing the fixture and
naming it in ``pytestmark``::

    from jax_departures import jax_detector_departures  # noqa: F401
    pytestmark = pytest.mark.usefixtures("jax_detector_departures")
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repas_tpu.detect import detector as JD
from repas_tpu.kernels.ccl import _connected_components_xla


def converged_components(mask: jnp.ndarray, iters: int = 5,
                         **_) -> jnp.ndarray:
    """(H,W) bool -> (H,W) int32: the JAX package's `iters` rounds, then
    jumps along the labels' chains and hooks of each root onto the least
    root among its 8 neighbours, until no root has a smaller neighbour:
    each 8-connected component's least linear index."""
    h, w = mask.shape
    sent = jnp.int32(h * w)
    lab = _connected_components_xla(mask, iters=iters)

    def jump(lab):
        def body(carry):
            lab, _ = carry
            flat = jnp.concatenate([lab.reshape(-1), sent[None]])
            nxt = jnp.where(mask, flat[lab.reshape(-1)].reshape(h, w), sent)
            return nxt, jnp.any(nxt != lab)

        return jax.lax.while_loop(lambda c: c[1], body,
                                  (lab, jnp.bool_(True)))[0]

    def body(carry):
        lab, _ = carry
        lab = jump(lab)
        p = jnp.pad(lab, 1, constant_values=sent)
        m = lab
        for dy in range(3):
            for dx in range(3):
                m = jnp.minimum(m, p[dy:dy + h, dx:dx + w])
        m = jnp.where(mask, m, sent)
        flat = jnp.concatenate([lab.reshape(-1), sent[None]])
        flat = flat.at[lab.reshape(-1)].min(m.reshape(-1))
        return (jnp.where(mask, flat[:h * w].reshape(h, w), sent),
                jnp.any(m < lab))

    return jax.lax.while_loop(lambda c: c[1], body,
                              (lab, jnp.bool_(True)))[0]


def member_support_points(labels: jnp.ndarray, roots: jnp.ndarray,
                          bbox: jnp.ndarray) -> jnp.ndarray:
    """``JD._support_points`` (its windows, levels and candidates as
    written there) with the port's tie rule. Returns (C,16,2)."""
    h, w = labels.shape
    ph, pw = min(JD._PATCH, h), min(JD._PATCH, w)
    m_pad = 8
    cover_x, cover_y = pw - 2 * m_pad, ph - 2 * m_pad
    n_levels = 1
    while (cover_x * 2 ** (n_levels - 1) < w
           or cover_y * 2 ** (n_levels - 1) < h) and n_levels < 4:
        n_levels += 1
    sentinel = jnp.int32(h * w)
    row_off, rows = [], []
    for lv in range(n_levels):
        a = labels[:: 2 ** lv, :: 2 ** lv]
        hl_, wl_ = a.shape
        row_off.append(sum(r.shape[0] for r in rows))
        rows.append(jnp.pad(a, ((0, max(ph - hl_, 0)), (0, w - wl_)),
                            constant_values=sentinel))
    pyr = jnp.concatenate(rows, axis=0)
    row_off = jnp.asarray(row_off, jnp.int32)
    starts_l, fits_l = [], []
    for lv in range(n_levels):
        s = 2 ** lv
        hl_ = max(rows[lv].shape[0], ph)
        wl_ = -(-w // s)
        starts_l.append(jnp.stack([
            jnp.clip(jnp.floor(bbox[:, 0] / s).astype(jnp.int32) - m_pad,
                     0, max(wl_ - pw, 0)),
            jnp.clip(jnp.floor(bbox[:, 1] / s).astype(jnp.int32) - m_pad,
                     0, max(hl_ - ph, 0))], axis=1))
        fits_l.append(((bbox[:, 2] - bbox[:, 0]) / s <= cover_x)
                      & ((bbox[:, 3] - bbox[:, 1]) / s <= cover_y))
    fits_all = jnp.stack(fits_l, axis=1)
    lvl = jnp.where(jnp.any(fits_all, axis=1), jnp.argmax(fits_all, axis=1),
                    n_levels - 1).astype(jnp.int32)
    starts = jnp.take_along_axis(
        jnp.stack(starts_l, axis=1), lvl[:, None, None], axis=1)[:, 0]
    scale = jnp.exp2(lvl.astype(jnp.float32))
    patches = jax.vmap(lambda lv_, st: jax.lax.dynamic_slice(
        pyr, (row_off[lv_] + st[1], st[0]), (ph, pw)))(lvl, starts)
    member = patches == roots[:, None, None]
    colf = jax.lax.broadcasted_iota(jnp.float32, (ph, pw), 1)
    neg = jnp.float32(-1e9)
    maxx = jnp.max(jnp.where(member, colf, neg), axis=2)
    minx = jnp.min(jnp.where(member, colf, -neg), axis=2)
    has = maxx > neg
    rowf = jax.lax.broadcasted_iota(jnp.float32, (1, ph), 1)
    cand_col = jnp.concatenate([minx, maxx], axis=1)
    cand_row = jnp.concatenate([rowf, rowf], axis=1)
    cand_ok = jnp.concatenate([has, has], axis=1)
    st_f = starts.astype(jnp.float32)
    xs = jnp.where(cand_ok, (st_f[:, 0:1] + cand_col) * scale[:, None], 0.0)
    ys = jnp.where(cand_ok, (st_f[:, 1:2] + cand_row) * scale[:, None], 0.0)
    x_root = (roots % w).astype(jnp.float32)
    y_root = (roots // w).astype(jnp.float32)
    outs = []
    for t in np.pi * 2.0 * np.arange(JD._NDIRS) / JD._NDIRS:
        c, s = np.float32(np.cos(t)), np.float32(np.sin(t))
        pm = jnp.where(cand_ok, xs * c + ys * s, neg)
        proj_root = x_root * c + y_root * s
        mx = jnp.maximum(jnp.max(pm, axis=1), proj_root)
        win = pm >= (mx[:, None] - 1e-3)
        root_win = proj_root >= (mx - 1e-3)
        ux = jnp.maximum(jnp.max(jnp.where(win, xs, neg), axis=1),
                         jnp.where(root_win, x_root, neg))
        uy = jnp.maximum(jnp.max(jnp.where(win, ys, neg), axis=1),
                         jnp.where(root_win, y_root, neg))
        # the port's rule: keep (ux, uy) where it is a tied candidate or
        # the tied candidates span at most a pixel of the level
        lx = jnp.minimum(jnp.min(jnp.where(win, xs, -neg), axis=1),
                         jnp.where(root_win, x_root, -neg))
        ly = jnp.minimum(jnp.min(jnp.where(win, ys, -neg), axis=1),
                         jnp.where(root_win, y_root, -neg))
        keep = (jnp.any(win & (xs == ux[:, None]) & (ys == uy[:, None]),
                        axis=1)
                | (root_win & (x_root == ux) & (y_root == uy))
                | ((ux - lx <= scale) & (uy - ly <= scale)))
        perp = jnp.where(win, ys * c - xs * s, neg)
        perp_root = jnp.where(root_win, y_root * c - x_root * s, neg)
        pmx = jnp.maximum(jnp.max(perp, axis=1), perp_root)
        end = win & (perp >= pmx[:, None])
        end_root = root_win & (perp_root >= pmx)
        ex = jnp.maximum(jnp.max(jnp.where(end, xs, neg), axis=1),
                         jnp.where(end_root, x_root, neg))
        ey = jnp.maximum(jnp.max(jnp.where(end, ys, neg), axis=1),
                         jnp.where(end_root, y_root, neg))
        outs.append(jnp.stack([jnp.where(keep, ux, ex),
                               jnp.where(keep, uy, ey)], axis=-1))
    return jnp.stack(outs, axis=1)


@contextlib.contextmanager
def applied(*modules):
    """The JAX package's detector (and each of `modules` that imported
    its ``connected_components`` or ``_support_points`` by name, such as
    the JAX tool ``tools/profile_stages.py``) with the two departures, for
    the block. Compiled traces are dropped on entry and on exit, so no
    trace of either version outlives it."""
    targets = [JD, *modules]
    saved = [(m, name, getattr(m, name)) for m in targets
             for name in ("connected_components", "_support_points")
             if hasattr(m, name)]
    jax.clear_caches()
    for m, name, _ in saved:
        setattr(m, name, converged_components
                if name == "connected_components" else member_support_points)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_detector_departures():
    """The JAX package's detector with the port's two departures, for the
    module's tests."""
    with applied():
        yield
