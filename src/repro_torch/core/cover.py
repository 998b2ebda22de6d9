"""k-interval cover computation (paper §4, Definitions 2-3, Eq. 19-25).

Given a node's interval set ``I = {I_1..I_N}`` (sorted, disjoint, each exact
or approximate) and a budget ``k``, produce a cover with at most ``k``
intervals minimizing the number of elements contained in *approximate* result
intervals (Eq. 19). Equivalent dual view: choose ≤ k-1 gaps to KEEP (Eq. 22).

Three algorithms, selectable everywhere via ``method=``:

  * ``dp``     — exact O(kN) dynamic program (the paper's Eq. 25, extended
                 with an explicit "last result interval is a lone exact
                 interval" state bit so exactness conversion costs are exact).
  * ``greedy`` — the paper's production algorithm: start from the 1-interval
                 cover, iteratively keep the gap with the greatest cost
                 reduction until k-1 gaps are kept.
  * ``topgap`` — beyond-paper TPU-friendly variant: keep the k-1 largest
                 gaps (one sort, no iteration). The cover of the staged
                 device pipeline (``core/build/``): every wave merge, every
                 tree-reduction round's re-cover, and the variant-"G" drain
                 (DESIGN.md §2); quality measured in benchmarks/cover_quality.

Cost model (Eq. 20-21): a result interval spanning originals i..j costs 0 if
i == j and η_i = 1, else (β_j - α_i + 1).
"""
from __future__ import annotations

import numpy as np

from . import intervals as iv

_BIG = np.int64(1) << 60


def cover(s: iv.IntervalSet, k: int, method: str = "greedy") -> iv.IntervalSet:
    """Return a ≤k-interval cover of ``s``."""
    n = iv.size(s)
    if k < 1:
        raise ValueError("budget k must be >= 1")
    if n <= k:
        return s
    if k == 1:
        b, e, _ = s
        return iv.make_set([b[0]], [e[-1]], [False])
    if method == "dp":
        keep = _dp_keep(s, k)
    elif method == "greedy":
        keep = _greedy_keep(s, k)
    elif method == "topgap":
        keep = _topgap_keep(s, k)
    else:
        raise ValueError(f"unknown cover method: {method}")
    return iv.merge_by_kept_gaps(s, keep)


def cover_cost(s: iv.IntervalSet) -> int:
    """c(·): number of elements inside approximate intervals (Eq. 20)."""
    return iv.approx_elements(s)


# ---------------------------------------------------------------- exact DP --

def _dp_keep(s: iv.IntervalSet, k: int) -> np.ndarray:
    """Exact optimum via the Eq. 25 recurrence.

    State: f[q][e] after processing prefix I_1..I_j, where q = gaps kept so
    far (≤ k-1) and e = 1 iff the last result interval is a single exact
    original (cost currently 0, pays its length if later merged).
    """
    b, e_, x = s
    n = b.size
    lens = (e_ - b + 1).astype(np.int64)
    gap = iv.gaps(s).astype(np.int64)
    kk = k - 1  # max gaps kept

    NEG = -1
    # f[q][e] = min cost; parent pointers for traceback
    f = np.full((kk + 1, 2), _BIG, dtype=np.int64)
    f[0][1 if x[0] else 0] = 0 if x[0] else lens[0]
    # choices[j][q][e] = (prev_q, prev_e, kept_gap_bool)
    choices = np.full((n, kk + 1, 2, 3), NEG, dtype=np.int64)

    for j in range(1, n):
        g = np.full((kk + 1, 2), _BIG, dtype=np.int64)
        lone_cost = np.int64(0 if x[j] else lens[j])
        new_e = 1 if x[j] else 0
        for q in range(min(j, kk) + 1):
            # option 1: keep gap γ_{j-1}  (needs q >= 1)
            if q >= 1:
                for pe in (0, 1):
                    c = f[q - 1][pe]
                    if c < _BIG:
                        cand = c + lone_cost
                        if cand < g[q][new_e]:
                            g[q][new_e] = cand
                            choices[j][q][new_e] = (q - 1, pe, 1)
            # option 2: merge I_j into the previous result interval
            for pe in (0, 1):
                c = f[q][pe]
                if c < _BIG:
                    extra = gap[j - 1] + lens[j] + (lens[j - 1] if pe else 0)
                    # NOTE: if pe == 1 the previous result interval is the
                    # lone exact I_{j-1}; merging converts it to approx.
                    cand = c + extra
                    if cand < g[q][0]:
                        g[q][0] = cand
                        choices[j][q][0] = (q, pe, 0)
        f = g

    # locate optimum
    best = (_BIG, -1, -1)
    for q in range(kk + 1):
        for e in (0, 1):
            if f[q][e] < best[0]:
                best = (f[q][e], q, e)
    _, q, e = best
    keep = np.zeros(max(n - 1, 0), dtype=bool)
    for j in range(n - 1, 0, -1):
        pq, pe, kept = choices[j][q][e]
        keep[j - 1] = bool(kept)
        q, e = int(pq), int(pe)
    return keep


def dp_cost(s: iv.IntervalSet, k: int) -> int:
    """Optimal cover cost (for property tests: greedy >= dp >= 0)."""
    return cover_cost(cover(s, k, method="dp"))


# ------------------------------------------------------------ paper greedy --

def _greedy_keep(s: iv.IntervalSet, k: int) -> np.ndarray:
    """Paper §4.1 greedy: iteratively keep the gap with max cost reduction.

    Implemented with explicit neighbor bookkeeping: keeping gap γ_i splits
    the merged run containing it; the reduction is |γ_i| plus the lengths of
    any adjacent lone exact originals that become exact again.
    """
    b, e_, x = s
    n = b.size
    lens = (e_ - b + 1).astype(np.int64)
    gap = iv.gaps(s).astype(np.int64)
    keep = np.zeros(n - 1, dtype=bool)

    for _ in range(k - 1):
        best_gain, best_i = -1, -1
        # run boundaries: interval i belongs to a run delimited by kept gaps
        # recompute runs each round — O(kN) total, N is small (≤ c·k·deg)
        run_id = np.zeros(n, dtype=np.int64)
        run_id[1:] = np.cumsum(keep)
        run_first = np.searchsorted(run_id, np.arange(run_id[-1] + 1), "left")
        run_last = np.searchsorted(run_id, np.arange(run_id[-1] + 1), "right") - 1
        for i in range(n - 1):
            if keep[i]:
                continue
            r = run_id[i]
            lo, hi = run_first[r], run_last[r]
            if lo == hi:
                continue  # cannot happen: gap i inside a run means hi>lo
            gain = int(gap[i])
            # left part becomes lone exact?
            if i == lo and x[lo]:
                gain += int(lens[lo])
            # right part becomes lone exact?
            if i + 1 == hi and x[hi]:
                gain += int(lens[hi])
            if gain > best_gain:
                best_gain, best_i = gain, i
        if best_i < 0:
            break
        keep[best_i] = True
    return keep


# ------------------------------------------------------- vectorized topgap --

def _topgap_keep(s: iv.IntervalSet, k: int) -> np.ndarray:
    """Keep the k-1 largest gaps (leftmost on ties). One argsort."""
    g = iv.gaps(s)
    n1 = g.size
    keep = np.zeros(n1, dtype=bool)
    if n1 == 0:
        return keep
    # stable sort on (-gap, index) → leftmost wins ties
    order = np.lexsort((np.arange(n1), -g))
    keep[order[: k - 1]] = True
    return keep


def topgap_keep_batch(gap_matrix: np.ndarray, valid: np.ndarray, k: int) -> np.ndarray:
    """Batched topgap for the wavefront constructor.

    gap_matrix: [B, G] gap lengths (invalid slots = -1), valid: [B, G] bool.
    Returns keep mask [B, G].
    """
    B, G = gap_matrix.shape
    gm = np.where(valid, gap_matrix, -1)
    order = np.argsort(-gm, axis=1, kind="stable")
    ranks = np.empty_like(order)
    rows = np.arange(B)[:, None]
    ranks[rows, order] = np.arange(G)[None, :]
    return (ranks < (k - 1)) & valid
