"""Tree cover, topological machinery and post-order labeling (paper §2, §4.2.1).

Everything here operates on the *condensed DAG*. The graph is augmented with
a virtual root r (id = n) connected to every source node (Eq. 5); the tree
cover is Algorithm 1: parent(v) = argmax_{u in N^-(v)} tau(u).

Outputs (all over the augmented node set, root included at index n):
  tau      [n+1]  topological order number, 1..n+1 (root gets 1)
  pi       [n+1]  post-order number, 1..n+1 (root gets n+1)
  tbegin   [n+1]  tree interval begin:  I_T(v) = [tbegin[v], pi[v]]  (Eq. 8)
  parent   [n+1]  tree parent (root -> -1)
  blevel   [n+1]  longest path to a sink (GRAIL topological level filter)
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from ..graphs.csr import CSR, build_csr, in_degrees


@dataclass
class TreeLabels:
    n: int                 # original node count (root is index n)
    tau: np.ndarray
    pi: np.ndarray
    tbegin: np.ndarray
    parent: np.ndarray
    blevel: np.ndarray
    tree_children: CSR     # children lists of the tree cover (over n+1 nodes)


def topological_order(g: CSR) -> np.ndarray:
    """Kahn's algorithm; deterministic FIFO tie-break. tau in 1..n."""
    n = g.n
    indeg = in_degrees(g)
    q = deque(int(v) for v in np.flatnonzero(indeg == 0))
    tau = np.zeros(n, dtype=np.int64)
    nxt = 1
    indptr, indices = g.indptr, g.indices
    while q:
        v = q.popleft()
        tau[v] = nxt
        nxt += 1
        for w in indices[indptr[v]: indptr[v + 1]]:
            w = int(w)
            indeg[w] -= 1
            if indeg[w] == 0:
                q.append(w)
    if nxt != n + 1:
        raise ValueError("graph is not a DAG (topological sort incomplete)")
    return tau


def backward_levels(g: CSR, tau: np.ndarray) -> np.ndarray:
    """blevel(v) = longest path from v to a sink. s~>t => blevel[s] > blevel[t]
    (for s != t), giving the pruning rule: blevel[s] <= blevel[t] => negative.
    Linear sweep in descending tau order."""
    n = g.n
    order = np.argsort(-tau, kind="stable")
    blevel = np.zeros(n, dtype=np.int64)
    indptr, indices = g.indptr, g.indices
    for v in order:
        v = int(v)
        row = indices[indptr[v]: indptr[v + 1]]
        if row.size:
            blevel[v] = int(blevel[row].max()) + 1
    return blevel


def tree_cover(g: CSR, tau: np.ndarray) -> np.ndarray:
    """Algorithm 1 (vectorized): parent[v] = argmax_{u in N^-(v)} tau(u).

    Sources get the virtual root (id n) as parent. Returns parent array of
    length n+1 with parent[n] = -1.
    """
    n = g.n
    src, dst = g.edges()
    parent = np.full(n + 1, n, dtype=np.int64)  # default: virtual root
    parent[n] = -1
    if src.size:
        # lexsort: primary dst, secondary tau[src] — last entry per dst is the
        # predecessor with max tau (ties: larger node id, deterministic)
        order = np.lexsort((src, tau[src], dst))
        s, d = src[order], dst[order]
        last = np.flatnonzero(np.r_[d[1:] != d[:-1], True])
        parent[d[last]] = s[last]
    return parent


def post_order(parent: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray, CSR]:
    """DFS post-order over the tree cover (children in ascending id order).

    Returns (pi, tbegin, tree_children). pi in 1..n+1; subtree identifiers are
    contiguous so tbegin[v] = pi[v] - subtree_size[v] + 1 (Eq. 8).
    """
    n_aug = n + 1
    child_src = parent[:n]  # every non-root node has a parent
    tree = build_csr(n_aug, child_src, np.arange(n, dtype=np.int64),
                     dedup=False)
    indptr, indices = tree.indptr, tree.indices
    pi = np.zeros(n_aug, dtype=np.int64)
    sz = np.ones(n_aug, dtype=np.int64)
    counter = 1
    # iterative DFS with edge cursors
    work = [(n, int(indptr[n]))]
    while work:
        v, ei = work[-1]
        if ei < indptr[v + 1]:
            work[-1] = (v, ei + 1)
            w = int(indices[ei])
            work.append((w, int(indptr[w])))
        else:
            work.pop()
            pi[v] = counter
            counter += 1
            if work:
                sz[work[-1][0]] += sz[v]
    tbegin = pi - sz + 1
    return pi, tbegin, tree


def wavefront_schedule(blevel: np.ndarray):
    """Wave schedule for the staged device constructor (DESIGN.md §2).

    Groups nodes into backward-level waves, sinks (blevel 0) first — every
    node's successors live at strictly smaller blevels, so each wave only
    reads results of earlier waves. Returns ``(order, bounds)``: wave ``lv``
    is ``order[bounds[lv]:bounds[lv + 1]]``; ``len(bounds) - 1`` waves.
    """
    order = np.argsort(blevel, kind="stable")
    bounds = np.searchsorted(blevel[order],
                             np.arange(blevel.max(initial=0) + 2))
    return order, bounds


def build_tree_labels(g: CSR) -> TreeLabels:
    """Full §2/§4.2.1 pipeline over a condensed DAG ``g``."""
    n = g.n
    tau = topological_order(g)
    blevel = backward_levels(g, tau)
    parent = tree_cover(g, tau)
    pi, tbegin, tree = post_order(parent, n)
    # augment tau/blevel with the root (tau 0 = before everyone; blevel above all)
    tau_aug = np.concatenate([tau, [0]])
    blevel_aug = np.concatenate([blevel, [blevel.max(initial=0) + 1]])
    return TreeLabels(n=n, tau=tau_aug, pi=pi, tbegin=tbegin, parent=parent,
                      blevel=blevel_aug, tree_children=tree)
