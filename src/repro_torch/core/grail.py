"""GRAIL baseline (Yıldırım et al., paper §3 / §6.2).

d random post-order traversals of the (augmented) DAG; label i of node v is
the approximate interval [low_i(v), rank_i(v)] with
low_i(v) = min(rank_i(v), min_{w in N+(v)} low_i(w)) — contains the rank of
every reachable node, possibly with false positives. Query processing: any
label excluding rank_i(t) → negative; otherwise guided DFS (no exact
intervals, so positives always require reaching t itself). Includes GRAIL's
topological level filter (same blevel as FERRARI uses).

The reference's numpy module with the port's imports; the port's
``backward_levels`` takes the DAG alone. The random post-orders draw in
the reference's order, so the same seed gives the same ranks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graphs.csr import CSR, in_degrees
from .scc import Condensation, condense
from .tree_cover import backward_levels, topological_order


@dataclass
class GrailIndex:
    cond: Condensation
    d: int
    rank: np.ndarray    # [d, n] random DFS post-order ranks
    low: np.ndarray     # [d, n]
    blevel: np.ndarray  # [n]
    tau: np.ndarray     # [n]

    def byte_size(self) -> int:
        return self.rank.nbytes + self.low.nbytes + self.blevel.nbytes // 2

    def stats_seconds(self) -> float:
        return getattr(self, "_seconds", 0.0)


def _random_postorder(dag: CSR, rng: np.random.Generator) -> np.ndarray:
    """Random DFS post-order over the DAG (sources visited in random order,
    children shuffled). Visited nodes skipped — effectively a random tree
    cover, as GRAIL prescribes."""
    n = dag.n
    indptr, indices = dag.indptr, dag.indices
    rank = np.zeros(n, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    counter = 1
    sources = np.flatnonzero(in_degrees(dag) == 0)
    rng.shuffle(sources)
    for s0 in sources:
        s0 = int(s0)
        if visited[s0]:
            continue
        visited[s0] = True
        # stack of (node, shuffled-children, cursor)
        ch = indices[indptr[s0]: indptr[s0 + 1]].copy()
        rng.shuffle(ch)
        work = [(s0, ch, 0)]
        while work:
            v, ch, i = work[-1]
            if i < len(ch):
                work[-1] = (v, ch, i + 1)
                w = int(ch[i])
                if not visited[w]:
                    visited[w] = True
                    cw = indices[indptr[w]: indptr[w + 1]].copy()
                    rng.shuffle(cw)
                    work.append((w, cw, 0))
            else:
                work.pop()
                rank[v] = counter
                counter += 1
    assert counter == n + 1
    return rank


def build_grail(g: CSR, d: int = 2, seed: int = 7,
                precondensed: bool = False) -> GrailIndex:
    import time
    t0 = time.perf_counter()
    if precondensed:
        cond = Condensation(comp=np.arange(g.n, dtype=np.int32), n_comp=g.n,
                            dag=g, comp_size=np.ones(g.n, dtype=np.int64))
    else:
        cond = condense(g)
    dag = cond.dag
    n = dag.n
    tau = topological_order(dag)
    blevel = backward_levels(dag)
    rng = np.random.default_rng(seed)
    rank = np.zeros((d, n), dtype=np.int64)
    low = np.zeros((d, n), dtype=np.int64)
    order = np.argsort(-tau, kind="stable")  # reverse topological
    indptr, indices = dag.indptr, dag.indices
    for i in range(d):
        rank[i] = _random_postorder(dag, rng)
        li = rank[i].copy()
        for v in order:
            v = int(v)
            row = indices[indptr[v]: indptr[v + 1]]
            if row.size:
                m = int(li[row].min())
                if m < li[v]:
                    li[v] = m
        low[i] = li
    ix = GrailIndex(cond=cond, d=d, rank=rank, low=low, blevel=blevel, tau=tau)
    ix._seconds = time.perf_counter() - t0
    return ix


class GrailQueryEngine:
    def __init__(self, index: GrailIndex):
        self.ix = index
        self.nodes_expanded = 0

    def _contains(self, u: int, t: int) -> bool:
        """All d labels of u contain rank(t)?"""
        ix = self.ix
        return bool(np.all((ix.low[:, u] <= ix.rank[:, t]) &
                           (ix.rank[:, t] <= ix.rank[:, u])))

    def reachable(self, s: int, t: int) -> bool:
        ix = self.ix
        cs, ct = int(ix.cond.comp[s]), int(ix.cond.comp[t])
        if cs == ct:
            return True
        return self._reach(cs, ct)

    def _reach(self, cs: int, ct: int) -> bool:
        ix = self.ix
        if ix.tau[cs] >= ix.tau[ct]:
            return False
        if ix.blevel[cs] <= ix.blevel[ct]:
            return False
        if not self._contains(cs, ct):
            return False
        dag = ix.cond.dag
        indptr, indices = dag.indptr, dag.indices
        visited = {cs}
        stack = [cs]
        while stack:
            u = stack.pop()
            self.nodes_expanded += 1
            for w_ in indices[indptr[u]: indptr[u + 1]]:
                w = int(w_)
                if w == ct:
                    return True
                if w in visited:
                    continue
                visited.add(w)
                if ix.tau[w] >= ix.tau[ct]:
                    continue
                if ix.blevel[w] <= ix.blevel[ct]:
                    continue
                if self._contains(w, ct):
                    stack.append(w)
        return False

    def batch(self, srcs, dsts) -> np.ndarray:
        return np.fromiter((self.reachable(int(s), int(t))
                            for s, t in zip(srcs, dsts)),
                           dtype=bool, count=len(srcs))
