"""Bounded incremental relabeling — fold a delta overlay into the index.

``compact_index`` turns (base FerrariIndex + overlay edges) into a fresh
FerrariIndex over the union graph, after which the overlay is empty and
serving returns to pure base-index speed. The reference's two paths
(``repro.reach.dynamic.relabel``), on the session's device:

incremental
    Valid while the union of the condensed DAG and the delta edges is still
    a DAG. label(v) is a function of v's tree interval and its successors'
    labels only (the paper's assignment sweep, §4.2), so the labels that
    change under insert-only updates are exactly the union-graph ancestors
    of the inserted edges' tails — a set closed under predecessors. The
    host machinery is recomputed whole (tau by Kahn, blevel by one reverse
    sweep, seed bitsets by two O(n + m) propagations), while the interval
    assignment re-runs the staged device pipeline over ONLY the affected
    waves (``core.build.pipeline.rebuild_affected``: kernel 5 on a card);
    unaffected labels are reused by reference. The tree cover, post-order
    pi and tbegin stay frozen from the base build: tree edges are a subset
    of the union graph, so tree intervals remain exact, and label
    intervals keep addressing the same pi-space.

full rebuild (explicit fallback)
    When a delta edge closes a cycle, when the base index is the k=∞
    baseline, or on request (``mode="full"``). Rebuilds over the union of
    the CONDENSED graph and composes the SCC maps:
    ``comp_new[orig] = comp_rebuild[comp_base[orig]]``.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np

from ...core.build.pipeline import rebuild_affected
from ...core.ferrari import BuildStats, FerrariIndex
from ...core.scc import Condensation
from ...core.seeds import build_seed_labels
from ...core.tree_cover import (TreeLabels, backward_levels,
                                topological_order)
from ...graphs.csr import CSR, build_csr, concat_rows, reverse_csr
from ..spec import COMPACT_MODES, IndexSpec  # single source of the enum


def union_dag(dag: CSR, dsrc: np.ndarray, ddst: np.ndarray) -> CSR:
    """The condensed DAG plus the delta edges (deduplicated)."""
    s0, d0 = dag.edges()
    return build_csr(dag.n,
                     np.concatenate([s0.astype(np.int64),
                                     np.asarray(dsrc, dtype=np.int64)]),
                     np.concatenate([d0.astype(np.int64),
                                     np.asarray(ddst, dtype=np.int64)]))


def affected_set(union: CSR, tails: np.ndarray) -> np.ndarray:
    """[n] bool: the union-graph ancestors of ``tails`` (tails included) —
    exactly the nodes whose reachable set can change under the inserts,
    and therefore the only labels ``compact_index`` recomputes. Each BFS
    level is one vectorized gather."""
    rev = reverse_csr(union)
    visited = np.zeros(union.n, dtype=bool)
    tails = np.unique(np.asarray(tails, dtype=np.int64))
    visited[tails] = True
    frontier = tails
    while frontier.size:
        nxt = np.unique(concat_rows(rev.indptr, rev.indices, frontier))
        nxt = nxt[~visited[nxt]]
        visited[nxt] = True
        frontier = nxt
    return visited


def compact_index(index: FerrariIndex, dsrc, ddst, spec: IndexSpec,
                  mode: str = "auto", device="cuda") -> FerrariIndex:
    """Fold condensed-id delta edges into ``index``; returns the new index.

    ``mode``: ``"incremental"`` demands the bounded path (raises ValueError
    if the union is not a DAG or the index cannot take it), ``"full"``
    forces the from-scratch rebuild, ``"auto"`` tries incremental and falls
    back. The chosen path is recorded in ``stats.builder``
    ("compact" | "full-rebuild"). Device work (the affected waves' merges,
    a wavefront rebuild) runs on ``device``.
    """
    if mode not in COMPACT_MODES:
        raise ValueError(f"mode must be one of {COMPACT_MODES}, got {mode!r}")
    dsrc = np.asarray(dsrc, dtype=np.int64)
    ddst = np.asarray(ddst, dtype=np.int64)
    union = union_dag(index.cond.dag, dsrc, ddst)
    if mode != "full":
        try:
            return _compact_incremental(index, union, dsrc, spec, device)
        except ValueError:
            if mode == "incremental":
                raise
    return _full_rebuild(index, union, spec, device)


def _compact_incremental(index: FerrariIndex, union: CSR, tails: np.ndarray,
                         spec: IndexSpec, device) -> FerrariIndex:
    n = index.tl.n
    if index.k is None or index.variant == "full":
        raise ValueError("the k=∞ Interval baseline has no budget to "
                         "relabel under; compact needs a full rebuild")
    t0 = time.perf_counter()
    tau = topological_order(union)        # raises ValueError on a cycle
    blevel = backward_levels(union)
    tl_new = TreeLabels(
        n=n,
        tau=np.concatenate([tau, [0]]),
        pi=index.tl.pi, tbegin=index.tl.tbegin, parent=index.tl.parent,
        blevel=np.concatenate([blevel, [blevel.max(initial=0) + 1]]),
        tree_children=index.tl.tree_children)
    affected = affected_set(union, tails)
    t_plan = time.perf_counter() - t0

    t0 = time.perf_counter()
    labels, info = rebuild_affected(
        union, tl_new, affected, index.labels, k=index.k,
        variant=index.variant, c=spec.c, merge_chunk=spec.merge_chunk,
        m_cap=spec.m_cap, device=device)
    t_assign = time.perf_counter() - t0

    seeds = None
    t0 = time.perf_counter()
    if index.seeds is not None:
        seeds = build_seed_labels(union, n_seeds=index.seeds.seed_ids.size)
    t_seeds = time.perf_counter() - t0

    old = index.stats
    stats = BuildStats(
        n=old.n, m=old.m + int(tails.size), n_comp=union.n,
        total_intervals=info["total_intervals"],
        exact_intervals=sum(int(np.sum(s[2])) for s in labels),
        budget=index.k * n,
        heap_recover_count=len(info["drain_order"]),
        seconds_condense=t_plan, seconds_tree=0.0,
        seconds_assign=t_assign, seconds_seeds=t_seeds,
        builder="compact",
        hub_nodes=info["hub_nodes"], merge_rounds=info["merge_rounds"],
        host_fallbacks=info["host_fallbacks"],
        peak_slab_bytes=info["peak_slab_bytes"],
        affected_nodes=info["affected_nodes"],
        waves_touched=info["waves_touched"],
        waves_total=info["waves_total"])
    cond = Condensation(comp=index.cond.comp, n_comp=index.cond.n_comp,
                        dag=union, comp_size=index.cond.comp_size)
    return FerrariIndex(cond=cond, tl=tl_new, labels=labels, seeds=seeds,
                        k=index.k, variant=index.variant, stats=stats)


def _full_rebuild(index: FerrariIndex, union: CSR, spec: IndexSpec,
                  device) -> FerrariIndex:
    """From-scratch build over the union of the CONDENSED graph.

    Reachability-equivalent to rebuilding over the original graph (every
    original node collapses to its base SCC first); a delta edge that
    closes a cycle across base SCCs is handled by the inner condensation,
    and the composed comp map keeps original ids addressable.
    """
    from ..spec import build as build_from_spec
    # honor the INDEX's budget (compact must not silently re-budget); the
    # k=∞ baseline is host-only ("topgap" remains a valid host cover)
    builder = "host" if index.k is None else spec.builder
    ix2 = build_from_spec(union, replace(
        spec, k=index.k, variant=index.variant, precondensed=False,
        builder=builder), device=device)
    comp = ix2.cond.comp[index.cond.comp].astype(np.int32)
    comp_size = np.bincount(comp, minlength=ix2.cond.n_comp).astype(np.int64)
    ix2.cond = Condensation(comp=comp, n_comp=ix2.cond.n_comp,
                            dag=ix2.cond.dag, comp_size=comp_size)
    ix2.stats.builder = "full-rebuild"
    ix2.stats.waves_total = ix2.stats.waves_touched = 0
    return ix2
