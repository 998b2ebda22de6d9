"""Query workload generation (paper §7.2: 100k random / 100k positive)."""
from __future__ import annotations

import numpy as np

from ..graphs.csr import CSR


def random_queries(g: CSR, q: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, g.n, size=q, dtype=np.int64),
            rng.integers(0, g.n, size=q, dtype=np.int64))


def random_edge_inserts(n: int, count: int, rng, order=None) -> tuple:
    """Random DAG-preserving edge-insert candidates: ``count`` node pairs
    oriented ascending in ``order`` (node ids when None), equal-order
    pairs dropped.

    Pass the index's SCC map (``index.cond.comp`` — a topological order
    of the condensed DAG by construction) to keep an insert stream on the
    bounded-compaction path of ``reach.dynamic`` for ANY base graph,
    cyclic ones included: every oriented insert goes low→high condensed
    id, so the union stays acyclic. The id-order default does the same
    only for id-ordered DAGs (random_dag, back_p=0 scale-free).
    Cycle-closing inserts remain correct either way — they just force
    compact()'s full-rebuild fallback. Shared by the serve churn loop and
    the churn benchmark so the two workloads cannot drift apart.
    """
    us = rng.integers(0, n, size=count)
    ud = rng.integers(0, n, size=count)
    key = np.arange(n, dtype=np.int64) if order is None else \
        np.asarray(order, dtype=np.int64)
    swap = key[us] > key[ud]
    lo = np.where(swap, ud, us)
    hi = np.where(swap, us, ud)
    keep = key[lo] != key[hi]
    return lo[keep], hi[keep]


def positive_queries(g: CSR, q: int, seed: int = 0, max_walk: int = 32):
    """Positive pairs via random forward walks (t is reachable from s by
    construction). Nodes with no out-edges yield (s, s) self-pairs, which are
    trivially positive — matching the paper's 'positive workload' semantics."""
    rng = np.random.default_rng(seed)
    indptr, indices = g.indptr, g.indices
    deg = np.diff(indptr)
    src = rng.integers(0, g.n, size=q, dtype=np.int64)
    # bias sources toward nodes that actually have out-edges
    has_out = np.flatnonzero(deg > 0)
    if has_out.size:
        redirect = rng.integers(0, has_out.size, size=q)
        src = np.where(deg[src] > 0, src, has_out[redirect])
    dst = src.copy()
    steps = rng.integers(1, max_walk + 1, size=q)
    for i in range(q):
        v = int(src[i])
        for _ in range(int(steps[i])):
            lo, hi = indptr[v], indptr[v + 1]
            if hi == lo:
                break
            v = int(indices[lo + rng.integers(0, hi - lo)])
        dst[i] = v
    return src, dst
