"""Kernel 5 of the port on the CPU: ``core.build.merge_kernels.
merge_cover_rows`` (the PyTorch prologue, then the plain version of the
merge + top-gap cover) against the reference's ``merge_cover_rows(impl=
"xla")`` on the same numpy inputs, and the plain version alone against the
reference's vmapped ``_merge_sorted_row`` + ``_topgap_cover_row`` — the
function the Pallas kernel computes. All outputs are integers or flags:
every comparison is exact equality.

Inputs cover equal begins (sort ties, the extra interval first), touching
intervals of differing exactness, nested intervals and holes inside exact
coverage, all-INVALID rows, rows with fewer runs than k, rows with more
runs than w_out, and gap ties, at working widths m of 1 to 2049.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.build.merge_kernels import (_merge_sorted_row,
                                            _topgap_cover_row)
from repro.core.build.merge_kernels import \
    merge_cover_rows as ref_merge_cover_rows
from repro_torch.core.build.merge_kernels import (gather_sorted,
                                                  merge_cover_rows)
from repro_torch.kernels import _lib
from repro_torch.kernels.merge_cover import (INVALID, MAX_STAGED_M,
                                             MAX_STAGED_W_OUT, merge_cover,
                                             merge_cover_plain, plan)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _table(rng, t_rows, w, spread):
    """A [t_rows, w] label table: random, nested, touching, tie-spaced and
    empty rows; the last row is the empty dummy row."""
    cnt = rng.integers(0, w + 1, t_rows)
    cnt[rng.random(t_rows) < 0.1] = 0
    cnt[-1] = 0
    b = rng.integers(0, spread, (t_rows, w))
    e = b + rng.integers(0, 4, (t_rows, w))
    x = rng.random((t_rows, w)) < 0.5
    for r in range(0, t_rows - 1, 4):              # gap ties: equal spacing
        b[r] = 7 * rng.integers(0, spread // 7 + 1) + 6 * np.arange(w)
        e[r] = b[r] + 2
    for r in range(1, t_rows - 1, 4):              # nested + touching
        b[r, 0], e[r, 0], x[r, 0] = 10, 40, False
        if w > 1:
            b[r, 1], e[r, 1], x[r, 1] = 15, 20, True
        if w > 2:
            b[r, 2], e[r, 2], x[r, 2] = 41, 45, True    # touches [10, 40]
        if w > 3:
            b[r, 3], e[r, 3], x[r, 3] = 46, 50, True    # touches, same type
    for r in range(2, t_rows - 1, 4):              # hole in exact coverage
        b[r, 0], e[r, 0], x[r, 0] = 100, 105, True
        if w > 1:
            b[r, 1], e[r, 1], x[r, 1] = 103, 120, False
        if w > 2:
            b[r, 2], e[r, 2], x[r, 2] = 108, 110, True
    dead = np.arange(w)[None, :] >= cnt[:, None]
    return (np.where(dead, INVALID, b).astype(np.int32),
            np.where(dead, -1, e).astype(np.int32), x & ~dead)


def _groups(rng, t_rows, b_rows, d, table_b):
    gi = rng.integers(0, t_rows, (b_rows, d))
    gi[rng.random((b_rows, d)) < 0.2] = t_rows - 1       # pad slots
    if b_rows > 1 and d:
        gi[1] = t_rows - 1                               # an all-dummy group
    # the extra interval: absent, random, or sharing a child's begin
    eb = rng.integers(0, 3 * t_rows, b_rows).astype(np.int32)
    if d:
        src = table_b[gi[:, 0], 0]
        eb = np.where((rng.random(b_rows) < 0.4) & (src < INVALID), src, eb)
    eb = np.where(rng.random(b_rows) < 0.25, INVALID, eb).astype(np.int32)
    ee = np.where(eb < INVALID, eb + rng.integers(0, 9, b_rows),
                  -1).astype(np.int32)
    if b_rows > 1:
        eb[1], ee[1] = INVALID, -1                       # all-INVALID row
    return gi, eb, ee


# (D source rows, table width W, groups B, k, w_out): m = D*W + 1
CASES = [
    (0, 8, 8, 8, 8),          # m = 1: the extra interval alone
    (1, 8, 32, 2, 2),         # m = 9: a sink-level wave at the default W
    (8, 8, 16, 8, 8),         # m = 65
    (64, 8, 4, 8, 8),         # m = 513: a tree-reduction round
    (256, 8, 2, 8, 8),        # m = 2049: the single-shot cap
    (4, 8, 16, 1, 1),         # k = 1: everything merges to one interval
    (16, 2, 8, 32, 32),       # k = 32: more room than runs
    (8, 4, 16, 12, 8),        # w_out below k: groups past w_out dropped
]


@pytest.mark.parametrize("d,w,b_rows,k,w_out", CASES)
def test_merge_cover_rows_matches_reference_xla(d, w, b_rows, k, w_out):
    rng = np.random.default_rng(d * 131 + w * 7 + k)
    t_rows = max(4 * d, 24)
    tb, te, tx = _table(rng, t_rows, w, spread=6 * t_rows)
    gi, eb, ee = _groups(rng, t_rows, b_rows, d, tb)
    m = d * w + 1
    want = ref_merge_cover_rows(
        jnp.asarray(tb), jnp.asarray(te), jnp.asarray(tx), jnp.asarray(gi),
        jnp.asarray(eb), jnp.asarray(ee), k=k, w_out=w_out, m=m, impl="xla")
    got = merge_cover_rows(_t(tb), _t(te), _t(tx.astype(np.int32)), _t(gi),
                           _t(eb), _t(ee), k=k, w_out=w_out, m=m)
    names = ("nb", "ne", "nx", "cnt")
    for name, g, ref in zip(names, got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref).astype(
            np.int32), err_msg=name)
    cnt = got[3].numpy()
    assert (cnt <= k).all() and (cnt[1] == 0 if b_rows > 1 and d else True)
    assert _lib.LAUNCHES["merge_cover"] == 0       # the CPU runs no kernel


def test_prologue_sort_order_matches_stable_argsort():
    """Heavy begin ties: the PyTorch stable sort visits equal begins in
    the order of the reference's ``jnp.argsort(stable=True)``, the extra
    interval first."""
    rng = np.random.default_rng(5)
    t_rows, w, d, b_rows = 40, 8, 16, 32
    tb = rng.integers(0, 5, (t_rows, w)).astype(np.int32)
    te = (tb + rng.integers(0, 3, (t_rows, w))).astype(np.int32)
    tx = (rng.random((t_rows, w)) < 0.5).astype(np.int32)
    gi = rng.integers(0, t_rows, (b_rows, d))
    eb = rng.integers(0, 5, b_rows).astype(np.int32)
    ee = (eb + 7).astype(np.int32)
    m = d * w + 9                                   # padded past D*W + 1
    cb, ce, cx = gather_sorted(_t(tb), _t(te), _t(tx), _t(gi), _t(eb),
                               _t(ee), m)
    rb = np.concatenate([eb[:, None], tb[gi].reshape(b_rows, -1),
                         np.full((b_rows, 8), INVALID, np.int32)], axis=1)
    re = np.concatenate([ee[:, None], te[gi].reshape(b_rows, -1),
                         np.full((b_rows, 8), -1, np.int32)], axis=1)
    order = np.asarray(jnp.argsort(jnp.asarray(rb), axis=1, stable=True))
    np.testing.assert_array_equal(cb.numpy(),
                                  np.take_along_axis(rb, order, 1))
    np.testing.assert_array_equal(ce.numpy(),
                                  np.take_along_axis(re, order, 1))
    # the extra interval leads its begin's tie block
    first = np.argmax(cb.numpy() == eb[:, None], axis=1)
    np.testing.assert_array_equal(ce.numpy()[np.arange(b_rows), first], ee)
    assert cx.dtype == torch.int32 and cx.shape == (b_rows, m)


def _sorted_rows(rng, b_rows, m, density, spread, max_len=6):
    cb = np.full((b_rows, m), INVALID, np.int32)
    ce = np.full((b_rows, m), -1, np.int32)
    cx = np.zeros((b_rows, m), np.int32)
    for i in range(b_rows):
        n_iv = min(m, rng.binomial(m, density)) if i % 5 else 0
        starts = np.sort(rng.integers(0, spread, n_iv))
        if i % 3 == 1:                              # equal gaps: ties
            starts = 9 * np.arange(n_iv)
        cb[i, :n_iv] = starts
        ce[i, :n_iv] = starts + rng.integers(0, max_len, n_iv)
        cx[i, :n_iv] = rng.integers(0, 2, n_iv)
    return cb, ce, cx


@pytest.mark.parametrize("m,w_out,k", [(1, 1, 1), (9, 32, 3), (65, 2, 8),
                                       (513, 8, 8), (2049, 32, 32)])
def test_plain_matches_reference_rows(m, w_out, k):
    """The function the Pallas kernel computes, on begin-sorted rows."""
    rng = np.random.default_rng(m + w_out)
    b_rows = 4 if m > 500 else 24
    cb, ce, cx = _sorted_rows(rng, b_rows, m, density=0.6, spread=4 * m)

    def row(b, e, x):
        ob, oe, ox, cnt = _merge_sorted_row(b, e, x)
        return _topgap_cover_row(ob, oe, ox, cnt, k, w_out)
    want = jax.vmap(row)(jnp.asarray(cb), jnp.asarray(ce), jnp.asarray(cx))
    got = merge_cover(_t(cb), _t(ce), _t(cx), k, w_out)
    for g, ref in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(ref).astype(np.int32))
    np.testing.assert_array_equal(
        merge_cover_plain(_t(cb), _t(ce), _t(cx), k, w_out)[0].numpy(),
        got[0].numpy())
    assert got[0].shape == (b_rows, w_out)


H100_SMEM = 232_448


# the card test's (m, k, w_out), then the staging limits and one past each
@pytest.mark.parametrize("m,k,w_out", [
    (1, 1, 1), (9, 2, 2), (9, 8, 8), (65, 8, 8), (513, 8, 8),
    (2049, 32, 32), (65, 12, 8), (33, 3, 32), (32, 8, 8), (33, 8, 8),
    (9, 8, 64), (9, 8, 65), (32, 33, 64), (2049, 33, 1000)])
def test_kernel_staging_plan_fits_shared_memory(m, k, w_out):
    """Kernel 5 stages a block's 128 begin rows up to m 32 and its output
    slabs up to w_out 64, in rows of odd stride; whatever it stages fits
    a block's 227 KB."""
    p = plan(m, w_out)
    assert p["rows"] == 128
    assert p["stage_cb"] == (m <= MAX_STAGED_M == 32)
    assert p["stage_out"] == (w_out <= MAX_STAGED_W_OUT == 64)
    want = 128 * 4 * (((m | 1) if p["stage_cb"] else 0)
                      + (3 * (w_out | 1) if p["stage_out"] else 0))
    assert p["smem"] == want <= H100_SMEM
    # the largest plan there is: both at their limits
    assert plan(MAX_STAGED_M, MAX_STAGED_W_OUT)["smem"] <= H100_SMEM
