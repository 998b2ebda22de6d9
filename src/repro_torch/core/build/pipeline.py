"""Staged device construction pipeline.

Stage 0  PLAN    — host: blevel wave schedule (`tree_cover.wavefront_schedule`),
                   per-wave degree census, and the split of each wave into
                   *fitting* nodes (single-shot merge) and *hub* nodes
                   (tree reduction) under the working-width cap ``m_cap``.
Stage 1  WAVES   — device: for each wave, fitting nodes merge+cover in one
                   `merge_cover_rows` call sized to THIS wave's max fitting
                   degree, hub nodes run the chunked tree reduction of
                   ``tree_merge.py``; both write the fixed-width [n+1, W]
                   label tables, which live on the device and are updated
                   in place.
Stage 2  DRAIN   — host (variant "G" only): post-hoc re-cover of oversized
                   nodes in stable lowest-out-degree order until the global
                   budget holds (Alg. 3 semantics, deferred).

Semantics: identical to the host ``assign_intervals(variant="L",
cover_method="topgap")`` for every node whose merge fan-in fits the working
width (deg·W + 1 ≤ m_cap). Hub nodes get a sound over-approximation from
the tree reduction — reach answers are unchanged, and no fan-in is ever
sent back to the host: ``host_fallbacks`` stays 0 by construction.

Variant "G-posthoc": nodes keep ≤ c·k intervals during the sweep; after all
levels, lowest-out-degree oversized nodes are re-covered to k until the
global budget holds (same budget semantics as Alg. 3; parents saw the
richer c·k sets).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ...graphs.csr import CSR
from ...obs import register_stats, span
from ..tree_cover import TreeLabels, build_tree_labels, wavefront_schedule
from .merge_kernels import INVALID, merge_cover_rows, slab_bytes
from .tree_merge import MergeStats, _pow2, ragged, reduce_wave

DEFAULT_MERGE_CHUNK = 64
# auto-m_cap keeps fan-in up to this degree on the host-bit-identical
# single-shot path; only genuinely hub-like nodes pay the tree reduction
SINGLE_SHOT_DEG = 256


def effective_widths(w_out: int, merge_chunk: int, m_cap: Optional[int]):
    """Resolve the (m_cap, chunk) policy for slab width W = w_out.

    ``m_cap`` is the maximum working width (interval slots) any single
    merge may allocate; ``None`` derives it from ``SINGLE_SHOT_DEG`` (or
    ``merge_chunk`` if larger), so moderate fan-in keeps the bit-identical
    single-shot merge and only real hubs tree-reduce. The reduction chunk
    shrinks to fit an explicit cap. Returns (m_cap, chunk); chunk ≥ 2 or
    the reduction could not terminate.
    """
    if m_cap is None:
        m_cap = max(merge_chunk, SINGLE_SHOT_DEG) * w_out + 1
    chunk = min(merge_chunk, (m_cap - 1) // w_out)
    if chunk < 2:
        raise ValueError(
            f"m_cap={m_cap} admits merge chunks of {chunk} rows at slab "
            f"width {w_out}; need >= 2 (m_cap >= {2 * w_out + 1})")
    return m_cap, chunk


def prior_peak_slab_bytes(deg: np.ndarray, blevel: np.ndarray, w_out: int,
                          scope: str = "wave") -> int:
    """Peak working set of the allocation rules this pipeline replaced —
    the yardstick for memory-regression checks.

    ``scope="wave"``: every wave padded to its OWN max degree with no
    fit/hub split, so one hub dictates the buffer of its whole wave.
    ``scope="global"``: the global slab (``max_m = global_max_deg·W + 1``)
    applied to the busiest wave — the upper bound both rules share.
    """
    waves = np.bincount(blevel, minlength=1)
    if scope == "global":
        b_pad = _pow2(int(waves.max(initial=1)))
        d_glob = int(deg.max(initial=0))
        d_pad = _pow2(d_glob) if d_glob > 0 else 1
        return slab_bytes(b_pad, d_pad * w_out + 1)
    if scope != "wave":
        raise ValueError(f"scope must be 'wave' or 'global', got {scope!r}")
    peak = 0
    for lv in range(waves.size):
        members = blevel == lv
        if not members.any():
            continue
        d_lv = int(deg[members].max(initial=0))
        d_pad = _pow2(d_lv) if d_lv > 0 else 1
        b_pad = _pow2(int(members.sum()))
        peak = max(peak, slab_bytes(b_pad, d_pad * w_out + 1))
    return peak


@dataclass
class WavefrontIndex:
    begins: np.ndarray      # [n+1, W] int32 (row n = dummy/empty)
    ends: np.ndarray
    exact: np.ndarray       # bool
    counts: np.ndarray
    tl: TreeLabels
    k: int
    levels: int
    seconds: float = 0.0
    # staged-pipeline accounting (MergeStats of both stages)
    hub_nodes: int = 0
    merge_rounds: int = 0
    host_fallbacks: int = 0
    peak_slab_bytes: int = 0
    drain_order: List[int] = field(default_factory=list)


def build_wavefront(dag: CSR, tl: Optional[TreeLabels] = None, k: int = 2,
                    c: int = 4, variant: str = "L",
                    budget: Optional[int] = None,
                    merge_chunk: int = DEFAULT_MERGE_CHUNK,
                    m_cap: Optional[int] = None,
                    device="cuda") -> WavefrontIndex:
    """Device wavefront construction over blevel waves (sinks first), on
    ``device`` ("cuda" by default; "cpu" runs kernel 5's plain version)."""
    from ..query_torch import resolve_device
    dev = resolve_device(device)
    t0 = time.perf_counter()
    n = dag.n
    with span("build.plan", n=int(n)):
        if tl is None:
            tl = build_tree_labels(dag)
        w_out = k if variant == "L" else c * k
        m_cap, chunk = effective_widths(w_out, merge_chunk, m_cap)
        order, bounds = wavefront_schedule(tl.blevel[:n])
        deg = dag.degrees()
    stats = MergeStats()

    i32 = dict(dtype=torch.int32, device=dev)
    begins = torch.full((n + 1, w_out), INVALID, **i32)
    ends = torch.full((n + 1, w_out), -1, **i32)
    exact = torch.zeros((n + 1, w_out), **i32)
    counts = np.zeros(n + 1, dtype=np.int32)

    tree_b_all = tl.tbegin[:n].astype(np.int32)
    tree_e_all = tl.pi[:n].astype(np.int32)
    n_levels = len(bounds) - 1
    with span("build.waves", levels=int(n_levels)):
        for lv in range(n_levels):
            nodes = order[bounds[lv]: bounds[lv + 1]]
            if nodes.size == 0:
                continue
            with span("build.wave", level=int(lv), nodes=int(nodes.size)):
                _merge_wave(begins, ends, exact, counts, nodes, deg[nodes],
                            m_cap, chunk, dag.indptr, dag.indices,
                            tree_b_all, tree_e_all, w_out, stats)

    ix = WavefrontIndex(begins=begins.cpu().numpy(), ends=ends.cpu().numpy(),
                        exact=exact.cpu().numpy() != 0, counts=counts,
                        tl=tl, k=k, levels=n_levels,
                        hub_nodes=stats.hub_nodes,
                        merge_rounds=stats.merge_rounds,
                        host_fallbacks=stats.host_fallbacks,
                        peak_slab_bytes=stats.peak_slab_bytes)
    if variant == "G":
        with span("build.drain", budget=int(budget or k * n)):
            ix.drain_order = _drain_to_budget(ix, dag, k, budget or k * n)
    ix.seconds = time.perf_counter() - t0
    return ix


def _merge_wave(begins, ends, exact, counts, nodes, deg_lv, m_cap: int,
                chunk: int, indptr, indices, tree_b_all, tree_e_all,
                w_out: int, stats: MergeStats) -> None:
    """One wave's merges: the fit/hub split, the single-shot call for
    fitting nodes, the tree reduction for hubs, and the write of their
    rows into the device tables (in place; ``counts`` on the host).
    Written for any subset of a wave's nodes, so an affected-subgraph
    rebuild can share it with the from-scratch build."""
    fits = deg_lv * w_out + 1 <= m_cap
    small, hubs = nodes[fits], nodes[~fits]
    dev = begins.device

    if small.size:
        nb, ne, nx, ncnt = _single_shot_wave(
            begins, ends, exact, small, int(deg_lv[fits].max(initial=0)),
            indptr, indices, tree_b_all, tree_e_all, w_out, stats)
        rows = torch.from_numpy(small).to(dev)
        begins[rows] = nb[: small.size]
        ends[rows] = ne[: small.size]
        exact[rows] = nx[: small.size]
        counts[small] = ncnt[: small.size].cpu().numpy()

    if hubs.size:
        hb, he, hx, hcnt = reduce_wave(
            begins, ends, exact, hubs, indptr, indices,
            tree_b_all[hubs], tree_e_all[hubs], w_out, chunk, stats)
        rows = torch.from_numpy(hubs).to(dev)
        begins[rows] = hb
        ends[rows] = he
        exact[rows] = hx
        counts[hubs] = hcnt.cpu().numpy()


def _single_shot_wave(begins, ends, exact, nodes, d_max, indptr, indices,
                      tree_b_all, tree_e_all, w_out: int, stats: MergeStats):
    """One wave of fitting nodes in one `merge_cover_rows` call.

    The working width is sized to THIS wave's max fitting degree (bucketed
    to powers of two), not to the global max degree; pad groups point at
    the dummy row and carry no tree interval, so they come out empty.
    """
    dev = begins.device
    n_dummy = begins.shape[0] - 1
    d_pad = _pow2(d_max) if d_max > 0 else 1
    b_pad = _pow2(nodes.size)
    deg = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
    owner, pos = ragged(deg)
    succ = np.full((b_pad, d_pad), n_dummy, dtype=np.int64)
    succ[owner, pos] = indices[indptr[nodes][owner] + pos]
    tb = np.full(b_pad, INVALID, dtype=np.int32)
    te = np.full(b_pad, -1, dtype=np.int32)
    tb[: nodes.size] = tree_b_all[nodes]
    te[: nodes.size] = tree_e_all[nodes]
    m_pad = d_pad * w_out + 1
    stats.record(b_pad, m_pad)
    return merge_cover_rows(begins, ends, exact,
                            torch.from_numpy(succ).to(dev),
                            torch.from_numpy(tb).to(dev),
                            torch.from_numpy(te).to(dev),
                            k=w_out, w_out=w_out, m=m_pad)


def _drain_to_budget(ix: WavefrontIndex, dag: CSR, k: int,
                     budget: int) -> List[int]:
    """Post-hoc global draining: re-cover lowest-out-degree oversized nodes
    to ≤ k until the total fits the budget (Alg. 3 semantics, deferred).
    Returns the drained node ids in drain order (stable lowest-out-degree
    first)."""
    from .. import cover as cov
    from .. import intervals as iv
    drained: List[int] = []
    total = int(ix.counts[:-1].sum())
    if total <= budget:
        return drained
    deg = dag.degrees()
    oversized = np.flatnonzero(ix.counts[:-1] > k)
    for v in oversized[np.argsort(deg[oversized], kind="stable")]:
        v = int(v)
        c = int(ix.counts[v])
        s = iv.make_set(ix.begins[v, :c], ix.ends[v, :c], ix.exact[v, :c])
        cv = cov.cover(s, k, method="topgap")
        nc = iv.size(cv)
        ix.begins[v, :] = INVALID
        ix.ends[v, :] = -1
        ix.exact[v, :] = False
        ix.begins[v, :nc] = cv[0]
        ix.ends[v, :nc] = cv[1]
        ix.exact[v, :nc] = cv[2]
        total += nc - c
        ix.counts[v] = nc
        drained.append(v)
        if total <= budget:
            break
    return drained


def rebuild_affected(dag: CSR, tl: TreeLabels, affected: np.ndarray,
                     labels_old, k: int, variant: str = "L", c: int = 4,
                     merge_chunk: int = DEFAULT_MERGE_CHUNK,
                     m_cap: Optional[int] = None,
                     budget: Optional[int] = None, device="cuda"):
    """Affected-subgraph entry point of the staged pipeline, on ``device``
    (kernel 5 in every wave merge on a card, its plain version on the
    CPU); the reference's ``rebuild_affected``.

    Re-runs PLAN → WAVES → DRAIN over only the nodes whose reachable set
    changed (``affected`` [n] bool — under insert-only updates, the union-
    graph ancestors of the inserted edges' tails, which is closed under
    predecessors, so every label whose merge inputs changed is itself
    recomputed). ``dag`` is the UNION condensed DAG; ``tl`` carries the
    union graph's recomputed tau/blevel beside the base build's frozen
    pi/tbegin/tree. Unaffected labels are written into the device tables
    once — wave merges of affected nodes read them in place — and returned
    by reference.

    Returns ``(labels, info)``: the per-node IntervalSets (+ virtual root)
    and a dict with the wave telemetry (``waves_total``/``waves_touched``/
    ``affected_nodes``), the MergeStats counters, the drain order, and
    ``total_intervals``.
    """
    from .. import intervals as iv
    from ..query_torch import resolve_device
    dev = resolve_device(device)
    n = dag.n
    w_out = k if variant == "L" else c * k
    m_cap, chunk = effective_widths(w_out, merge_chunk, m_cap)
    widths = np.fromiter((labels_old[v][0].size for v in range(n)),
                         dtype=np.int64, count=n)
    if int(widths.max(initial=0)) > w_out:
        raise ValueError(
            f"existing labels up to {int(widths.max())} intervals exceed "
            f"the slab width {w_out} for variant={variant!r}, k={k} — "
            "compact must fall back to a full rebuild")

    # the unaffected rows, scattered in one vectorized write
    keep = np.flatnonzero(~affected[:n])
    counts = np.zeros(n + 1, dtype=np.int32)
    counts[keep] = widths[keep]
    cnt = widths[keep]
    rows = np.repeat(keep, cnt)
    cols = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    begins_np = np.full((n + 1, w_out), np.int32(INVALID), dtype=np.int32)
    ends_np = np.full((n + 1, w_out), -1, dtype=np.int32)
    exact_np = np.zeros((n + 1, w_out), dtype=np.int32)
    if rows.size:
        for slab, part in ((begins_np, 0), (ends_np, 1), (exact_np, 2)):
            slab[rows, cols] = np.concatenate(
                [labels_old[v][part] for v in keep])

    begins = torch.from_numpy(begins_np).to(dev)
    ends = torch.from_numpy(ends_np).to(dev)
    exact = torch.from_numpy(exact_np).to(dev)
    tree_b_all = tl.tbegin[:n].astype(np.int32)
    tree_e_all = tl.pi[:n].astype(np.int32)
    deg = dag.degrees()
    stats = MergeStats()

    order, bounds = wavefront_schedule(tl.blevel[:n])
    n_levels = len(bounds) - 1
    waves_touched = 0
    with span("build.waves", levels=int(n_levels), affected=True):
        for lv in range(n_levels):
            nodes = order[bounds[lv]: bounds[lv + 1]]
            nodes = nodes[affected[nodes]]
            if nodes.size == 0:
                continue
            waves_touched += 1
            with span("build.wave", level=int(lv), nodes=int(nodes.size)):
                _merge_wave(begins, ends, exact, counts, nodes, deg[nodes],
                            m_cap, chunk, dag.indptr, dag.indices,
                            tree_b_all, tree_e_all, w_out, stats)

    wf = WavefrontIndex(begins=begins.cpu().numpy(), ends=ends.cpu().numpy(),
                        exact=exact.cpu().numpy() != 0, counts=counts,
                        tl=tl, k=k, levels=n_levels,
                        hub_nodes=stats.hub_nodes,
                        merge_rounds=stats.merge_rounds,
                        host_fallbacks=stats.host_fallbacks,
                        peak_slab_bytes=stats.peak_slab_bytes)
    if variant == "G":
        wf.drain_order = _drain_to_budget(wf, dag, k, budget or k * n)

    touched = affected.copy()
    touched[wf.drain_order] = True        # drained rows changed in the slab
    labels = [iv.make_set(wf.begins[v, : wf.counts[v]],
                          wf.ends[v, : wf.counts[v]],
                          wf.exact[v, : wf.counts[v]])
              if touched[v] else labels_old[v] for v in range(n)]
    labels.append(iv.single(1, n + 1, True))          # virtual root
    info = {
        "waves_total": n_levels,
        "waves_touched": waves_touched,
        "affected_nodes": int(affected.sum()),
        "hub_nodes": stats.hub_nodes,
        "merge_rounds": stats.merge_rounds,
        "host_fallbacks": stats.host_fallbacks,
        "peak_slab_bytes": stats.peak_slab_bytes,
        "drain_order": wf.drain_order,
        "total_intervals": int(wf.counts[:-1].sum()) + 1,
    }
    return labels, info


def labels_from_wavefront(ix: WavefrontIndex):
    """Per-node IntervalSets: views of the rows of the build's tables
    (int32 begins and ends, bool exact), held to ``intervals.make_set``'s
    rules (begin <= end, sorted and disjoint) in one pass over the
    tables."""
    n = ix.tl.n
    b, e, x = ix.begins[:n], ix.ends[:n], ix.exact[:n]
    counts = ix.counts[:n]
    live = np.arange(b.shape[1])[None, :] < counts[:, None]
    if np.any((b > e) & live):
        raise ValueError("interval with begin > end")
    if np.any((b[:, 1:] <= e[:, :-1]) & live[:, 1:]):
        raise ValueError("intervals must be sorted and disjoint")
    return [(b[v, :c], e[v, :c], x[v, :c])
            for v, c in enumerate(counts.tolist())]


def build_index_device(g: CSR, k: int = 2, variant: str = "G", c: int = 4,
                       cover_method: str = "topgap", n_seeds: int = 32,
                       use_seeds: bool = True, precondensed: bool = False,
                       merge_chunk: int = DEFAULT_MERGE_CHUNK,
                       m_cap: Optional[int] = None,
                       budget: Optional[int] = None, device="cuda"):
    """End-to-end device construction producing a host-queryable
    ``FerrariIndex`` — the `builder="wavefront"` target of ``reach.build``.

    Same pipeline shape as ``core.ferrari.build_index`` (condense → tree
    cover → interval assignment → seeds) with the assignment stage replaced
    by the staged device pipeline above, on ``device``. Device covering is
    top-gap; ``cover_method`` must be "topgap".
    """
    from .. import intervals as iv
    from ..ferrari import BuildStats, FerrariIndex
    from ..query_torch import resolve_device
    from ..scc import Condensation, condense
    from ..seeds import build_seed_labels
    if variant not in ("L", "G"):
        raise ValueError("builder='wavefront' supports variants 'L'/'G' "
                         f"(got {variant!r}); use the host builder for "
                         "the k=None full baseline")
    if cover_method != "topgap":
        raise ValueError("the device builder covers with 'topgap' only "
                         f"(got cover_method={cover_method!r})")
    dev = resolve_device(device)
    st = BuildStats(n=g.n, m=g.m, budget=k * g.n, builder="wavefront")
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

    wf = build_wavefront(cond.dag, tl, k=k, c=c, variant=variant,
                         budget=budget, merge_chunk=merge_chunk, m_cap=m_cap,
                         device=dev)
    st.seconds_assign = wf.seconds
    st.heap_recover_count = len(wf.drain_order)
    st.hub_nodes = wf.hub_nodes
    st.merge_rounds = wf.merge_rounds
    st.host_fallbacks = wf.host_fallbacks
    st.peak_slab_bytes = wf.peak_slab_bytes

    n_aug = tl.n + 1
    labels = labels_from_wavefront(wf)
    labels.append(iv.single(1, n_aug, True))        # virtual root
    st.total_intervals = int(wf.counts[:-1].sum()) + 1
    # the exact flags within each row's count, and the root's
    w = wf.exact.shape[1]
    st.exact_intervals = int((wf.exact[:tl.n] & (
        np.arange(w)[None, :] < wf.counts[:tl.n, None])).sum()) + 1

    seeds = None
    if use_seeds:
        t0 = time.perf_counter()
        with span("build.seeds", n_seeds=int(n_seeds)):
            seeds = build_seed_labels(cond.dag, n_seeds=n_seeds)
        st.seconds_seeds = time.perf_counter() - t0

    return FerrariIndex(cond=cond, tl=tl, labels=labels, seeds=seeds, k=k,
                        variant=variant, stats=st)
