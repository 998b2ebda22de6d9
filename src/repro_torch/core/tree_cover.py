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

from dataclasses import dataclass

import numpy as np

from ..graphs.csr import CSR, build_csr, concat_rows, in_degrees


@dataclass
class TreeLabels:
    n: int                 # original node count (root is index n)
    tau: np.ndarray
    pi: np.ndarray
    tbegin: np.ndarray
    parent: np.ndarray
    blevel: np.ndarray
    tree_children: CSR     # children lists of the tree cover (over n+1 nodes)


def kahn_fronts(g: CSR) -> list:
    """Kahn's algorithm with a FIFO queue, one front at a time: the
    queue's pops are the sources in id order, then the nodes each front
    releases, in the order the queue took them (the last of a node's
    in-edges in the front's rows, read in pop order). A node's front is
    its longest path from a source, so every edge goes to a later front.
    Returns the fronts ([k] int64 arrays) in pop order."""
    n = g.n
    indeg = in_degrees(g)
    indptr, indices = g.indptr, g.indices
    front = np.flatnonzero(indeg == 0)
    fronts, done = [], 0
    while front.size:
        fronts.append(front)
        done += front.size
        seq = concat_rows(indptr, indices, front)    # in-edges in pop order
        if not seq.size:
            break
        order = np.argsort(seq, kind="stable")
        s = seq[order]
        first = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
        last = order[np.r_[first[1:], s.size] - 1]   # a node's last in-edge
        nodes = s[first].astype(np.int64)
        indeg[nodes] -= np.diff(np.r_[first, s.size])
        ready = indeg[nodes] == 0
        front = nodes[ready][np.argsort(last[ready], kind="stable")]
    if done != n:
        raise ValueError("graph is not a DAG (topological sort incomplete)")
    return fronts


def _tau(fronts: list, n: int) -> np.ndarray:
    tau = np.zeros(n, dtype=np.int64)
    if fronts:
        tau[np.concatenate(fronts)] = np.arange(1, n + 1)
    return tau


def topological_order(g: CSR) -> np.ndarray:
    """Kahn's algorithm; deterministic FIFO tie-break. tau in 1..n."""
    return _tau(kahn_fronts(g), g.n)


def _blevels(g: CSR, fronts: list) -> np.ndarray:
    """Longest path to a sink, one front at a time from the last: a
    node's successors all lie in later fronts."""
    blevel = np.zeros(g.n, dtype=np.int64)
    indptr, indices = g.indptr, g.indices
    for front in reversed(fronts):
        lens = indptr[front + 1] - indptr[front]
        nodes, lens = front[lens > 0], lens[lens > 0]
        if nodes.size:
            rows = blevel[concat_rows(indptr, indices, nodes)]
            blevel[nodes] = np.maximum.reduceat(
                rows, np.cumsum(lens) - lens) + 1
    return blevel


def backward_levels(g: CSR) -> np.ndarray:
    """blevel(v) = longest path from v to a sink. s~>t => blevel[s] > blevel[t]
    (for s != t), giving the pruning rule: blevel[s] <= blevel[t] => negative.
    A sweep over Kahn's fronts from the last."""
    return _blevels(g, kahn_fronts(g))


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
    """DFS post-order over the tree cover (children in ascending id order),
    computed a tree level at a time: subtree sizes from the leaves up,
    first numbers from the root down.

    Returns (pi, tbegin, tree_children). pi in 1..n+1; subtree identifiers are
    contiguous so tbegin[v] = pi[v] - subtree_size[v] + 1 (Eq. 8).
    """
    n_aug = n + 1
    child_src = parent[:n]  # every non-root node has a parent
    tree = build_csr(n_aug, child_src, np.arange(n, dtype=np.int64),
                     dedup=False)
    indptr, indices = tree.indptr, tree.indices
    # the tree's levels from the root down
    levels = [np.array([n], dtype=np.int64)]
    while True:
        kids = concat_rows(indptr, indices, levels[-1]).astype(np.int64)
        if not kids.size:
            break
        levels.append(kids)
    sz = np.ones(n_aug, dtype=np.int64)
    for lv in reversed(levels[1:]):
        np.add.at(sz, parent[lv], sz[lv])
    # the DFS enters a child after its earlier siblings' subtrees: its
    # first post-order number is its parent's plus their sizes
    ksz = sz[indices]
    before = np.cumsum(ksz) - ksz     # a prefix over all rows, less
    lens = np.diff(indptr)
    before -= np.repeat(before[indptr[:-1][lens > 0]], lens[lens > 0])
    # ... the prefix at its row's start
    offset = np.zeros(n_aug, dtype=np.int64)
    offset[indices] = before
    tbegin = np.ones(n_aug, dtype=np.int64)
    for lv in levels[1:]:
        tbegin[lv] = tbegin[parent[lv]] + offset[lv]
    pi = tbegin + sz - 1
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
    fronts = kahn_fronts(g)
    tau = _tau(fronts, n)
    blevel = _blevels(g, fronts)
    parent = tree_cover(g, tau)
    pi, tbegin, tree = post_order(parent, n)
    # augment tau/blevel with the root (tau 0 = before everyone; blevel above all)
    tau_aug = np.concatenate([tau, [0]])
    blevel_aug = np.concatenate([blevel, [blevel.max(initial=0) + 1]])
    return TreeLabels(n=n, tau=tau_aug, pi=pi, tbegin=tbegin, parent=parent,
                      blevel=blevel_aug, tree_children=tree)
