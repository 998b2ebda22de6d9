"""Seed-based pruning labels (paper §5.1).

Choose the s highest-degree nodes (min degree 1) of the condensed DAG as
seeds. Every node v carries two bitsets:

    S+(v) = { σ : v ~> σ }   (seeds reachable FROM v)
    S-(v) = { σ : σ ~> v }   (seeds that REACH v)

Query rules for (s, t):
  1. S+(s) ∩ S-(t) ≠ ∅                        →  positive (path through σ)
  2. ∃σ: σ ∈ S-(s) ∧ σ ∉ S-(t)               →  negative (σ~>s, s~>t would
                                                  imply σ~>t)
  3. (dual, free and sound) ∃σ: σ ∈ S+(t) ∧ σ ∉ S+(s) → negative.

Bitsets are uint32 words (s = 32 → one word per node per direction), stored
as [n, words] arrays so the device kernel tests them with two loads + AND.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graphs.csr import CSR, concat_rows, in_degrees


@dataclass
class SeedLabels:
    seed_ids: np.ndarray   # [s] node ids of the seeds
    s_plus: np.ndarray     # [n, words] uint32
    s_minus: np.ndarray    # [n, words] uint32

    @property
    def n_words(self) -> int:
        return self.s_plus.shape[1]

    def byte_size(self) -> int:
        return self.s_plus.nbytes + self.s_minus.nbytes + self.seed_ids.nbytes


def _propagate(dag: CSR, fronts: list, init: np.ndarray,
               direction: str) -> np.ndarray:
    """OR-propagate seed bits along edges, a Kahn front at a time
    (``tree_cover.kahn_fronts``: every edge goes to a later front).

    direction='up': S+ — node inherits from successors; fronts from the
    last, each node ORing its successors' rows.
    direction='down': S- — node inherits from predecessors; fronts from
    the first, each front's rows ORed into its successors.
    """
    out = init.copy()
    indptr, indices = dag.indptr, dag.indices
    for front in (reversed(fronts) if direction == "up" else fronts):
        lens = indptr[front + 1] - indptr[front]
        nodes, lens = front[lens > 0], lens[lens > 0]
        if not nodes.size:
            continue
        succ = concat_rows(indptr, indices, nodes)
        if direction == "up":
            out[nodes] |= np.bitwise_or.reduceat(
                out[succ], np.cumsum(lens) - lens, axis=0)
            continue
        order = np.argsort(succ, kind="stable")
        succ = succ[order]
        first = np.flatnonzero(np.r_[True, succ[1:] != succ[:-1]])
        out[succ[first]] |= np.bitwise_or.reduceat(
            out[np.repeat(nodes, lens)[order]], first, axis=0)
    return out


def build_seed_labels(dag: CSR, n_seeds: int = 32) -> SeedLabels:
    from .tree_cover import kahn_fronts
    n = dag.n
    fronts = kahn_fronts(dag)
    deg = dag.degrees() + in_degrees(dag)
    n_seeds = min(n_seeds, int(np.sum(deg >= 1)))
    # top-degree nodes, deterministic tie-break by id
    order = np.lexsort((np.arange(n), -deg))
    seed_ids = np.sort(order[:n_seeds]).astype(np.int64)
    words = max(1, (n_seeds + 31) // 32)

    init = np.zeros((n, words), dtype=np.uint32)
    w = np.arange(n_seeds) // 32
    b = np.arange(n_seeds) % 32
    init[seed_ids, w] |= (np.uint32(1) << b.astype(np.uint32))

    s_plus = _propagate(dag, fronts, init, "up")
    s_minus = _propagate(dag, fronts, init, "down")
    return SeedLabels(seed_ids=seed_ids, s_plus=s_plus, s_minus=s_minus)


def seed_verdict(lbl: SeedLabels, s: int, t: int) -> int:
    """+1 positive, -1 negative, 0 unknown — host reference of the kernel's
    seed logic."""
    sp_s, sm_s = lbl.s_plus[s], lbl.s_minus[s]
    sp_t, sm_t = lbl.s_plus[t], lbl.s_minus[t]
    if np.any(sp_s & sm_t):
        return 1
    if np.any(sm_s & ~sm_t):
        return -1
    if np.any(sp_t & ~sp_s):
        return -1
    return 0
