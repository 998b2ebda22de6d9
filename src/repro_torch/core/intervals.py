"""Interval algebra for reachability interval sets (paper §2, §4).

An *interval set* is the label of one node: a sorted, disjoint collection of
integer intervals ``[begin, end]`` each carrying an exactness flag ``eta``
(1 = exact: every contained post-order id is reachable; 0 = approximate:
contained ids MAY be reachable, ids outside are definitely NOT).

Represented as a triple of equal-length numpy arrays ``(begins, ends, exact)``
with ``begins`` strictly increasing and ``ends[i] < begins[i+1]``.

Merge semantics (paper §2.1 + footnote 1):
  * overlapping intervals are always unioned;
  * an element of the union is *exact-covered* if at least one exact input
    interval contains it; a union interval is exact iff ALL its elements are
    exact-covered (so exact ⊒ approx subsumption stays exact, approx ⊒ exact
    subsumption becomes approx, extension of exact by approx becomes one long
    approximate range — exactly the paper's examples);
  * adjacent (touching, non-overlapping) intervals are merged only when the
    merge is lossless for pruning, i.e. both exact or both approximate.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IntervalSet = Tuple[np.ndarray, np.ndarray, np.ndarray]

_I32 = np.int64  # ids fit int32 but int64 avoids overflow in len sums


def empty_set() -> IntervalSet:
    z = np.zeros(0, dtype=_I32)
    return z, z.copy(), np.zeros(0, dtype=bool)


def make_set(begins, ends, exact) -> IntervalSet:
    b = np.asarray(begins, dtype=_I32)
    e = np.asarray(ends, dtype=_I32)
    x = np.asarray(exact, dtype=bool)
    if b.ndim != 1 or b.shape != e.shape or b.shape != x.shape:
        raise ValueError("interval set arrays must be 1-D and equal length")
    if np.any(b > e):
        raise ValueError("interval with begin > end")
    if b.size > 1 and not np.all(b[1:] > e[:-1]):
        raise ValueError("intervals must be sorted and disjoint")
    return b, e, x


def single(begin: int, end: int, exact: bool = True) -> IntervalSet:
    return (np.array([begin], dtype=_I32), np.array([end], dtype=_I32),
            np.array([exact], dtype=bool))


def size(s: IntervalSet) -> int:
    """Number of intervals in the set."""
    return int(s[0].size)


def n_elements(s: IntervalSet) -> int:
    """Total number of integer elements covered."""
    b, e, _ = s
    return int(np.sum(e - b + 1))


def approx_elements(s: IntervalSet) -> int:
    """Number of elements inside approximate intervals (the paper's cost)."""
    b, e, x = s
    if b.size == 0:
        return 0
    return int(np.sum((e - b + 1) * (~x)))


def contains(s: IntervalSet, point: int) -> Tuple[bool, bool]:
    """Return (hit_any, hit_exact) for a stabbing query at ``point``.

    O(log N) binary search — the host-side analogue of the Pallas
    ``interval_stab`` kernel's per-lane masked compare.
    """
    b, e, x = s
    if b.size == 0:
        return False, False
    i = int(np.searchsorted(b, point, side="right")) - 1
    if i < 0:
        return False, False
    if point <= e[i]:
        return True, bool(x[i])
    return False, False


def merge_many(sets) -> IntervalSet:
    """Union-merge several interval sets (the ⊕ of Alg. 2 line 9).

    Single O(L log L) sweep over all constituent intervals. Resolves
    subsumption and extension exhaustively; tracks exactness per the
    exact-coverage semantics documented in the module docstring.
    """
    sets = [s for s in sets if s[0].size]
    if not sets:
        return empty_set()
    if len(sets) == 1:
        return sets[0]
    b = np.concatenate([s[0] for s in sets])
    e = np.concatenate([s[1] for s in sets])
    x = np.concatenate([s[2] for s in sets])
    order = np.argsort(b, kind="stable")
    return _sweep(b[order], e[order], x[order])


def _sweep(b: np.ndarray, e: np.ndarray, x: np.ndarray) -> IntervalSet:
    """Sweep over begin-sorted intervals producing the normalized union.

    Maintains the current union interval [cb, ce], the prefix [cb, ece]
    proven covered by exact intervals, and whether an exact-coverage hole has
    appeared (once holed, later intervals cannot repair it because begins are
    non-decreasing).
    """
    n = b.size
    ob, oe, ox = [], [], []
    cb = ce = ece = 0
    holed = True
    open_ = False

    def flush():
        nonlocal open_
        if open_:
            ob.append(cb)
            oe.append(ce)
            ox.append((not holed) and ece >= ce)
            open_ = False

    # note: ``holed`` only turns True on an IRREPARABLE exact-coverage gap
    # (an exact interval starting beyond ece+1 — later begins are ≥ it, so
    # the gap can never be filled). Opening with an approximate interval is
    # NOT a hole: a same/later-begin exact interval may still cover from cb.
    for i in range(n):
        bi, ei, xi = int(b[i]), int(e[i]), bool(x[i])
        if not open_:
            cb, ce = bi, ei
            ece = ei if xi else bi - 1
            holed = False
            open_ = True
            continue
        cur_exact = (not holed) and ece >= ce
        if bi > ce + 1:
            # strictly beyond (with a gap): close current, start new
            flush()
            cb, ce = bi, ei
            ece = ei if xi else bi - 1
            holed = False
            open_ = True
            continue
        if bi == ce + 1:
            # touching: merge only if exactness-type preserving
            if cur_exact == xi:
                pass  # type-preserving: fall through to merge below
            else:
                flush()
                cb, ce = bi, ei
                ece = ei if xi else bi - 1
                holed = False
                open_ = True
                continue
        # overlap (or type-preserving touch): extend the union interval
        ce = max(ce, ei)
        if xi:
            if bi <= ece + 1:
                ece = max(ece, ei)
            else:
                holed = True  # exact coverage hole — cannot be repaired
        # approx intervals never advance ece
    flush()
    return (np.asarray(ob, dtype=_I32), np.asarray(oe, dtype=_I32),
            np.asarray(ox, dtype=bool))


def merge_two(a: IntervalSet, c: IntervalSet) -> IntervalSet:
    return merge_many([a, c])


def gaps(s: IntervalSet) -> np.ndarray:
    """Gap lengths |γ_i| between consecutive intervals (paper §4.1)."""
    b, e, _ = s
    if b.size < 2:
        return np.zeros(0, dtype=_I32)
    return b[1:] - e[:-1] - 1


def merge_by_kept_gaps(s: IntervalSet, keep: np.ndarray) -> IntervalSet:
    """ζ(G): induced cover keeping gaps where ``keep`` is True (len N-1).

    A result interval is exact iff it is a single original exact interval.
    """
    b, e, x = s
    n = b.size
    if n == 0:
        return s
    keep = np.asarray(keep, dtype=bool)
    assert keep.size == max(n - 1, 0)
    # group id increments whenever the preceding gap is kept
    grp = np.zeros(n, dtype=np.int64)
    if n > 1:
        grp[1:] = np.cumsum(keep)
    ng = int(grp[-1]) + 1
    nb = np.zeros(ng, dtype=_I32)
    ne = np.zeros(ng, dtype=_I32)
    nx = np.zeros(ng, dtype=bool)
    first = np.ones(ng, dtype=bool)
    cnt = np.zeros(ng, dtype=np.int64)
    np.add.at(cnt, grp, 1)
    # vectorized: first/last index of each group
    firsts = np.searchsorted(grp, np.arange(ng), side="left")
    lasts = np.searchsorted(grp, np.arange(ng), side="right") - 1
    nb = b[firsts]
    ne = e[lasts]
    nx = (cnt == 1) & x[firsts]
    return nb, ne, nx


def validate(s: IntervalSet) -> None:
    b, e, x = s
    assert b.shape == e.shape == x.shape
    assert np.all(b <= e)
    if b.size > 1:
        assert np.all(b[1:] > e[:-1]), "intervals overlap or unsorted"


def to_tuples(s: IntervalSet):
    b, e, x = s
    return [(int(b[i]), int(e[i]), bool(x[i])) for i in range(b.size)]
