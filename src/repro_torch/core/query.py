"""Host reference query engine (paper §5) — guided DFS with all filters.

This is the faithful single-query algorithm; `query_torch.py` implements the
batched two-phase device engine with identical semantics (cross-checked by
property tests). Also usable as the production fallback for graphs too large
for device phase-2 expansion.
"""
from __future__ import annotations

from dataclasses import MISSING, dataclass, field, fields

import numpy as np

from .ferrari import FerrariIndex
from .seeds import seed_verdict


class ResettableStats:
    """Mixin: ``reset()`` restores every dataclass field to its default."""

    def reset(self) -> None:
        """Clear all counters (between workloads, after warmup, ...)."""
        for f in fields(self):
            setattr(self, f.name,
                    f.default_factory() if f.default_factory is not MISSING
                    else f.default)


@dataclass
class QueryStats(ResettableStats):
    n_queries: int = 0
    n_positive: int = 0
    answered_scc: int = 0        # [u] == [v] early positive
    answered_filters: int = 0    # tau / blevel / seed rules
    answered_stab: int = 0       # exact hit or total miss at the source
    answered_expand: int = 0     # required guided DFS
    nodes_expanded: int = 0
    # live-update path (reach.dynamic) — mirrored on ServeStats/SessionStats
    # so per-workload phase mixes stay attributable under churn; reset()
    # covers them via the ResettableStats field sweep
    n_updates: int = 0
    n_overlay_hits: int = 0
    n_compactions: int = 0


class QueryEngine:
    """Reference engine. ``use_seeds`` / ``use_filters`` toggles mirror the
    paper's heuristics ablation (§5.1-5.2)."""

    def __init__(self, index: FerrariIndex, use_seeds: bool = True,
                 use_filters: bool = True):
        self.ix = index
        self.use_seeds = use_seeds and index.seeds is not None
        self.use_filters = use_filters
        self.stats = QueryStats()

    # ------------------------------------------------------------------ API
    def reachable(self, s: int, t: int) -> bool:
        """Answer one query on ORIGINAL node ids."""
        ix = self.ix
        self.stats.n_queries += 1
        cs = int(ix.cond.comp[s])
        ct = int(ix.cond.comp[t])
        if cs == ct:
            self.stats.answered_scc += 1
            self.stats.n_positive += 1
            return True
        r = self._reachable_condensed(cs, ct)
        if r:
            self.stats.n_positive += 1
        return r

    def batch(self, srcs, dsts) -> np.ndarray:
        return np.fromiter((self.reachable(int(s), int(t))
                            for s, t in zip(srcs, dsts)),
                           dtype=bool, count=len(srcs))

    # ------------------------------------------------------------- internal
    def _filters(self, u: int, ct: int) -> int:
        """+1 definite positive, -1 definite negative, 0 unknown.
        Applies (in cheap-first order): topological order (Eq. 11),
        topological level (§5.2), seed rules (§5.1)."""
        ix = self.ix
        tl = ix.tl
        if self.use_filters:
            if tl.tau[u] >= tl.tau[ct]:
                return -1
            if tl.blevel[u] <= tl.blevel[ct]:
                return -1
        if self.use_seeds:
            return seed_verdict(ix.seeds, u, ct)
        return 0

    def _reachable_condensed(self, cs: int, ct: int) -> bool:
        ix = self.ix
        v = self._filters(cs, ct)
        if v != 0:
            self.stats.answered_filters += 1
            return v > 0
        tpi = int(ix.tl.pi[ct])
        hit, exact = ix.stab(cs, tpi)
        if exact:
            self.stats.answered_stab += 1
            return True
        if not hit:
            self.stats.answered_stab += 1
            return False
        # approximate hit: guided DFS (paper §5)
        self.stats.answered_expand += 1
        dag = ix.cond.dag
        indptr, indices = dag.indptr, dag.indices
        visited = {cs}
        stack = [cs]
        expanded = 0
        while stack:
            u = stack.pop()
            expanded += 1
            row = indices[indptr[u]: indptr[u + 1]]
            for w_ in row:
                w = int(w_)
                if w == ct:
                    self.stats.nodes_expanded += expanded
                    return True
                if w in visited:
                    continue
                visited.add(w)
                f = self._filters(w, ct)
                if f > 0:
                    self.stats.nodes_expanded += expanded
                    return True
                if f < 0:
                    continue
                hit, exact = ix.stab(w, tpi)
                if exact:
                    self.stats.nodes_expanded += expanded
                    return True
                if hit:
                    stack.append(w)  # approximate: keep searching below w
        self.stats.nodes_expanded += expanded
        return False


def brute_force_reachable(indptr, indices, s: int, t: int) -> bool:
    """Plain BFS ground truth for tests."""
    if s == t:
        return True
    from collections import deque
    seen = {s}
    q = deque([s])
    while q:
        u = q.popleft()
        for w_ in indices[indptr[u]: indptr[u + 1]]:
            w = int(w_)
            if w == t:
                return True
            if w not in seen:
                seen.add(w)
                q.append(w)
    return False


def brute_force_closure(g) -> np.ndarray:
    """Dense n×n boolean transitive closure (tests only, n small)."""
    n = g.n
    reach = np.zeros((n, n), dtype=bool)
    indptr, indices = g.indptr, g.indices
    for v in range(n):
        reach[v, v] = True
    # reverse-topological accumulation would need tau; plain DFS per node is
    # fine at test sizes
    for s in range(n):
        stack = [s]
        seen = reach[s]
        while stack:
            u = stack.pop()
            for w_ in indices[indptr[u]: indptr[u + 1]]:
                w = int(w_)
                if not seen[w]:
                    seen[w] = True
                    stack.append(w)
    return reach
