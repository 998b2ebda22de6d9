"""Strongly connected component condensation (paper §2, "Condensed Graph").

Iterative Tarjan (explicit stack — web graphs blow the Python recursion
limit). Produces the condensed DAG G_C plus the node -> component map used at
query time (queries (u, v) map to ([u], [v]); early-positive when equal).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graphs.csr import CSR, build_csr


@dataclass
class Condensation:
    comp: np.ndarray      # [n] int32: node -> SCC id (a topological order: if
                          # C1 -> C2 in the condensed DAG then id(C1) < id(C2))
    n_comp: int
    dag: CSR              # condensed DAG over SCC ids
    comp_size: np.ndarray  # [n_comp]


def condense(g: CSR) -> Condensation:
    n = g.n
    comp = _tarjan(g)
    n_comp = int(comp.max()) + 1 if n else 0
    # Tarjan assigns component ids in reverse topological order; flip so that
    # edges in the condensed DAG always go from lower to higher id.
    comp = (n_comp - 1) - comp
    src, dst = g.edges()
    csrc, cdst = comp[src], comp[dst]
    keep = csrc != cdst
    dag = build_csr(n_comp, csrc[keep], cdst[keep])
    sizes = np.bincount(comp, minlength=n_comp).astype(np.int64)
    return Condensation(comp=comp.astype(np.int32), n_comp=n_comp, dag=dag,
                        comp_size=sizes)


def _tarjan(g: CSR) -> np.ndarray:
    """Iterative Tarjan SCC. Returns comp ids in reverse-topological order
    (the component of a 'later' node gets a smaller id)."""
    n = g.n
    indptr, indices = g.indptr, g.indices
    UNVISITED = -1
    index = np.full(n, UNVISITED, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    stack: list[int] = []
    counter = 0
    n_comp = 0

    for root in range(n):
        if index[root] != UNVISITED:
            continue
        # work stack entries: (node, next-edge-cursor)
        work = [(root, indptr[root])]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ei = work[-1]
            if ei < indptr[v + 1]:
                work[-1] = (v, ei + 1)
                w = int(indices[ei])
                if index[w] == UNVISITED:
                    index[w] = low[w] = counter
                    counter += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, indptr[w]))
                elif on_stack[w]:
                    if index[w] < low[v]:
                        low[v] = index[w]
            else:
                work.pop()
                if work:
                    p = work[-1][0]
                    if low[v] < low[p]:
                        low[p] = low[v]
                if low[v] == index[v]:
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp[w] = n_comp
                        if w == v:
                            break
                    n_comp += 1
    return comp


def is_dag(g: CSR) -> bool:
    """Fast Kahn check (vectorized peel)."""
    indeg = np.zeros(g.n, dtype=np.int64)
    np.add.at(indeg, g.indices, 1)
    frontier = np.flatnonzero(indeg == 0)
    seen = 0
    indeg = indeg.copy()
    while frontier.size:
        seen += frontier.size
        # decrement in-degrees of all successors of the frontier
        parts = [g.indices[g.indptr[v]: g.indptr[v + 1]] for v in frontier]
        if parts:
            cat = np.concatenate(parts) if len(parts) > 1 else parts[0]
            np.subtract.at(indeg, cat, 1)
        indeg[frontier] = -1
        frontier = np.flatnonzero(indeg == 0)
    return seen == g.n
