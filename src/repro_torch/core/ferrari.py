"""FERRARI index construction — the paper's core contribution (§4.2, §4.3).

Faithful host-side implementation of:
  * Algorithm 2 (FERRARI-L): local budget — every node label covered to ≤ k
    intervals immediately after merging its successors' sets.
  * Algorithm 3 (FERRARI-G): global budget — labels covered to ≤ c·k first
    (c = 4 per §4.3); oversized nodes parked in a min-out-degree heap; when
    the running total exceeds B = k·n, heap nodes are popped and re-covered
    to ≤ k until the budget holds again (deferred interval merging).
  * k = ∞ variant: the full interval transitive closure of Agrawal et al.
    (the paper's "Interval" baseline, §6/§7).

This module is the *paper-faithful baseline* recorded in EXPERIMENTS.md §Perf;
`core/build/` holds the beyond-paper staged device pipeline (wavefront waves
+ chunked tree-reduction merge for hub fan-in, DESIGN.md §2).
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..graphs.csr import CSR
from . import cover as cov
from . import intervals as iv
from .scc import Condensation, condense
from .seeds import SeedLabels, build_seed_labels
from .tree_cover import TreeLabels, build_tree_labels


@dataclass
class BuildStats:
    n: int = 0
    m: int = 0
    n_comp: int = 0
    total_intervals: int = 0
    exact_intervals: int = 0
    budget: int = 0
    heap_recover_count: int = 0          # FERRARI-G deferred re-coverings
    seconds_condense: float = 0.0
    seconds_tree: float = 0.0
    seconds_assign: float = 0.0
    seconds_seeds: float = 0.0
    # staged device pipeline (core.build) — zeros for the host sweep
    builder: str = "host"
    hub_nodes: int = 0                   # nodes merged by tree reduction
    merge_rounds: int = 0                # total merge kernel rounds
    host_fallbacks: int = 0              # fan-ins sent back to the host
    peak_slab_bytes: int = 0             # largest merge working set
    # bounded incremental relabeling (reach.dynamic compact, DESIGN.md §6)
    # — zeros for from-scratch builds
    affected_nodes: int = 0              # labels recomputed by compact()
    waves_touched: int = 0               # waves the compact pipeline re-ran
    waves_total: int = 0                 # waves in the full schedule

    @property
    def seconds_total(self) -> float:
        return (self.seconds_condense + self.seconds_tree +
                self.seconds_assign + self.seconds_seeds)


@dataclass
class FerrariIndex:
    """The queryable index over the condensed DAG (plus node mapping)."""
    cond: Condensation
    tl: TreeLabels
    labels: List[iv.IntervalSet]         # per condensed node (+ root at n)
    seeds: Optional[SeedLabels]
    k: Optional[int]
    variant: str
    stats: BuildStats = field(default_factory=BuildStats)

    # ------------------------------------------------------------ size ----
    def n_intervals(self) -> int:
        return sum(iv.size(s) for s in self.labels[: self.tl.n])

    def byte_size(self) -> int:
        """Index size: intervals (2x int32 + flag bit packed into sign) +
        pi/tau/blevel (int32 each) + seed bitsets."""
        n = self.tl.n
        sz = self.n_intervals() * 8 + n * 4 * 3 + n * 8  # offsets
        if self.seeds is not None:
            sz += self.seeds.byte_size()
        return sz

    # ------------------------------------------------------- membership ---
    def stab(self, v: int, target_pi: int):
        """(hit_any, hit_exact) of target_pi against label of condensed v."""
        return iv.contains(self.labels[v], target_pi)


def assign_intervals(dag: CSR, tl: TreeLabels, k: Optional[int],
                     variant: str = "L", c: int = 4,
                     cover_method: str = "greedy"):
    """Algorithms 2 & 3 (and the k=∞ full-TC variant).

    Returns (labels, heap_recover_count, total_intervals).
    """
    n = dag.n
    n_aug = n + 1
    order = np.argsort(-tl.tau[:n], kind="stable")  # reverse topological
    indptr, indices = dag.indptr, dag.indices

    labels: List[Optional[iv.IntervalSet]] = [None] * n_aug
    full = k is None
    budget = 0 if full else k * n
    ck = 0 if full else c * k
    s_total = 0
    heap: list = []            # (out_degree, node) min-heap — Alg. 3 line 14
    oversized = set()
    recovered = 0

    for v in order:
        v = int(v)
        tree_iv = iv.single(int(tl.tbegin[v]), int(tl.pi[v]), True)
        succ = indices[indptr[v]: indptr[v + 1]]
        if succ.size:
            parts = [tree_iv] + [labels[int(w)] for w in succ]
            merged = iv.merge_many(parts)
        else:
            merged = tree_iv
        if full:
            labels[v] = merged
            s_total += iv.size(merged)
            continue
        if variant == "L":
            lab = cov.cover(merged, k, method=cover_method)
            labels[v] = lab
            s_total += iv.size(lab)
        elif variant == "G":
            lab = cov.cover(merged, ck, method=cover_method)
            labels[v] = lab
            s_total += iv.size(lab)
            if iv.size(lab) > k:
                heapq.heappush(heap, (int(succ.size), v))
                oversized.add(v)
            # Alg. 3 lines 15-18: drain until the global budget holds
            while s_total > budget and heap:
                _, w = heapq.heappop(heap)
                if w not in oversized:
                    continue
                oversized.discard(w)
                old = iv.size(labels[w])
                labels[w] = cov.cover(labels[w], k, method=cover_method)
                s_total += iv.size(labels[w]) - old
                recovered += 1
        else:
            raise ValueError(f"unknown variant {variant!r}")

    # virtual root: covers the whole id range exactly (it reaches everything
    # through tree edges by construction)
    labels[n] = iv.single(1, n_aug, True)
    s_total += 1
    return labels, recovered, s_total


def build_index(g: CSR, k: Optional[int] = 2, variant: str = "G", c: int = 4,
                cover_method: str = "greedy", n_seeds: int = 32,
                use_seeds: bool = True, precondensed: bool = False) -> FerrariIndex:
    """End-to-end §4.2 pipeline: condense → tree cover → interval assignment
    → seed labels. ``k=None`` builds the full Interval baseline.

    ``precondensed=True`` skips Tarjan when the input is already a DAG (the
    paper also excludes condensation from its measurements, §7.2).
    """
    from ..obs import register_stats, span
    st = BuildStats(n=g.n, m=g.m, budget=(0 if k is None else k * g.n))
    register_stats("reach_build", st)

    t0 = time.perf_counter()
    with span("build.condense", n=int(g.n), m=int(g.m)):
        if precondensed:
            cond = Condensation(comp=np.arange(g.n, dtype=np.int32),
                                n_comp=g.n, dag=g,
                                comp_size=np.ones(g.n, dtype=np.int64))
        else:
            cond = condense(g)
    st.seconds_condense = time.perf_counter() - t0
    st.n_comp = cond.n_comp

    t0 = time.perf_counter()
    with span("build.tree"):
        tl = build_tree_labels(cond.dag)
    st.seconds_tree = time.perf_counter() - t0

    t0 = time.perf_counter()
    with span("build.assign", variant=variant):
        labels, recovered, total = assign_intervals(
            cond.dag, tl, k, variant=variant, c=c, cover_method=cover_method)
    st.seconds_assign = time.perf_counter() - t0
    st.heap_recover_count = recovered
    st.total_intervals = total
    st.exact_intervals = sum(int(np.sum(s[2])) for s in labels if s is not None)

    seeds = None
    if use_seeds:
        t0 = time.perf_counter()
        with span("build.seeds", n_seeds=int(n_seeds)):
            seeds = build_seed_labels(cond.dag, n_seeds=n_seeds)
        st.seconds_seeds = time.perf_counter() - t0

    return FerrariIndex(cond=cond, tl=tl, labels=labels, seeds=seeds, k=k,
                        variant=("full" if k is None else variant), stats=st)


def build_interval_baseline(g: CSR, **kw) -> FerrariIndex:
    """The paper's 'Interval' competitor: full transitive-closure intervals."""
    kw.setdefault("use_seeds", False)
    return build_index(g, k=None, **kw)
