"""Synthetic graph generators.

The paper evaluates on benchmark DAGs (ArXiV, GO, Pubmed, CiteSeer, ...) and
web-scale graphs (Twitter, Web-UK). None of those datasets ship with this
container, so the benchmark harness uses structurally analogous synthetic
generators: random layered DAGs (citation-like), scale-free digraphs with
SCCs (web-like), random trees, and Erdős–Rényi DAGs. Every generator is
seeded and deterministic.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR, build_csr, remove_self_loops


def random_dag(n: int, avg_deg: float, seed: int = 0) -> CSR:
    """Erdős–Rényi-style DAG: edges only from lower to higher id."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n - 1, size=2 * m, dtype=np.int64)
    dst = rng.integers(1, n, size=2 * m, dtype=np.int64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    lo, hi = lo[keep][:m], hi[keep][:m]
    return build_csr(n, lo, hi)


def layered_dag(n: int, n_layers: int, avg_deg: float, skip_p: float = 0.1,
                seed: int = 0) -> CSR:
    """Citation-network-like DAG: nodes in layers, edges to next layers.

    ``skip_p`` fraction of edges skip ≥2 layers (long-range citations).
    """
    rng = np.random.default_rng(seed)
    layer = np.sort(rng.integers(0, n_layers, size=n))
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=2 * m, dtype=np.int64)
    jump = np.where(rng.random(2 * m) < skip_p,
                    rng.integers(2, max(3, n_layers // 3), size=2 * m), 1)
    tgt_layer = layer[src] + jump
    # choose a random node in the target layer via searchsorted on the sorted
    # layer array (nodes are sorted by layer)
    lo = np.searchsorted(layer, tgt_layer, side="left")
    hi = np.searchsorted(layer, tgt_layer, side="right")
    ok = hi > lo
    src, lo, hi = src[ok], lo[ok], hi[ok]
    dst = lo + (rng.random(src.size) * (hi - lo)).astype(np.int64)
    src, dst = src[:m], dst[:m]
    src, dst = remove_self_loops(n, src, dst)
    return build_csr(n, src, dst)


def scale_free_digraph(n: int, avg_deg: float, seed: int = 0,
                       back_p: float = 0.15) -> CSR:
    """Preferential-attachment digraph WITH cycles (web/social-like).

    ``back_p`` fraction of edges point backwards (id-descending), creating
    non-trivial SCCs — exercises the condensation path like Twitter/Web-UK.
    """
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    # preferential attachment approximated by sampling targets ∝ 1/rank
    u = rng.random(m)
    dst = np.minimum((n ** u).astype(np.int64), n - 1)  # Zipf-ish toward low ids
    src = rng.integers(0, n, size=m, dtype=np.int64)
    back = rng.random(m) < back_p
    s = np.where(back, np.maximum(src, dst), np.minimum(src, dst))
    d = np.where(back, np.minimum(src, dst), np.maximum(src, dst))
    s, d = remove_self_loops(n, s, d)
    return build_csr(n, s, d)


def add_hub_edges(g: CSR, hub_deg: int, seed: int = 0, hub: int = 0) -> CSR:
    """Return ``g`` plus a web-style hub: node ``hub`` gains edges to
    ``hub_deg`` distinct random targets (the fan-in shape that exercises
    the tree-reduction merge of the device constructor, DESIGN.md §2)."""
    rng = np.random.default_rng(seed)
    pool = np.delete(np.arange(g.n, dtype=np.int64), hub)
    tgt = rng.choice(pool, size=hub_deg, replace=False)
    s, d = g.edges()
    return build_csr(g.n, np.concatenate([s.astype(np.int64),
                                          np.full(hub_deg, hub, np.int64)]),
                     np.concatenate([d.astype(np.int64), tgt]))


def random_tree(n: int, seed: int = 0, max_parent_gap: int = 64) -> CSR:
    """Random rooted tree (node 0 = root), edges parent -> child."""
    rng = np.random.default_rng(seed)
    child = np.arange(1, n, dtype=np.int64)
    lo = np.maximum(0, child - max_parent_gap)
    parent = lo + (rng.random(n - 1) * (child - lo)).astype(np.int64)
    return build_csr(n, parent, child)


def deep_path_dag(n: int, branch_p: float = 0.05, seed: int = 0) -> CSR:
    """Mostly a long path with occasional branches — worst case for
    level-synchronous algorithms (depth ≈ n)."""
    rng = np.random.default_rng(seed)
    src = np.arange(0, n - 1, dtype=np.int64)
    dst = src + 1
    nb = int(n * branch_p)
    bs = rng.integers(0, n - 2, size=nb)
    bd = bs + rng.integers(2, 16, size=nb)
    keep = bd < n
    src = np.concatenate([src, bs[keep]])
    dst = np.concatenate([dst, bd[keep]])
    return build_csr(n, src, dst)


def small_example_graph() -> CSR:
    """The paper's Figure 1 example graph (augmented form built by callers).

    Nodes: a=0 b=1 c=2 d=3 e=4 f=5 g=6 (as in Fig. 1a, without root).
    Edges chosen to reproduce the paper's tree/interval walkthrough:
    a->c, a->d, c->e, d->e, b->d, b->f, g->f  (g, a, b are sources).
    """
    edges = [(0, 2), (0, 3), (2, 4), (3, 4), (1, 3), (1, 5), (6, 5)]
    src = [u for u, _ in edges]
    dst = [v for _, v in edges]
    return build_csr(7, src, dst)
