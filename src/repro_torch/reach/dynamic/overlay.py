"""DeltaOverlay — edge inserts beside a static index, on the engine's device.

The FERRARI index is exact for the graph it was built over; a single edge
insert invalidates nothing *if the query path can also traverse the new
edge*. The overlay holds appended edges (condensed-id space) in a
fixed-capacity COO slab and makes the serving engines answer over the
**union graph** (base adjacency + delta slab) without touching the index,
with the reference's semantics (``repro.reach.dynamic.overlay``):

  * The delta slab rides the sparse phase 2's COO tail: every delta edge
    whose source is in a query's front contributes its head as a
    candidate, like a hub node's spilled edges (kernel 3's tail sweep).
    Padding entries are (0, 0) self-edges, dropped by the visited bitset.

  * A base-NEG node may now reach the target *through* a delta edge, so
    the overlay keeps ``can_reach_tail``: the exact set of nodes that
    reach at least one delta-edge source (tail) in the union graph. A
    base-NEG candidate with ``can_reach_tail`` set is UNKNOWN (kernel 4's
    overlay rule); a union path from a base-NEG node to the target must
    cross a delta edge, hence reach that edge's tail first. The set only
    grows under inserts and is refreshed by one reverse union BFS from the
    newly added tails per ``add`` batch.

The host parts (``add``, ``_mark_ancestors``, ``host_reachable``,
``edges``) are numpy. ``union_tail_state`` writes the union tables into
tensors the engine allocates once, at fixed shapes, and updates in place
(``copy_``) on every later batch: their ``data_ptr`` never change, so the
sparse loop's state and the CUDA graph captured from those pointers serve
every batch.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...graphs.csr import CSR, concat_rows, reverse_csr


class OverlayFull(RuntimeError):
    """Raised by ``DeltaOverlay.add`` when a batch exceeds the slab
    capacity; callers compact (``QuerySession`` does so automatically
    when ``spec.auto_compact``) and retry."""


class DeltaOverlay:
    """Fixed-capacity insert-only edge overlay over a condensed DAG."""

    def __init__(self, dag: CSR, cap: int):
        if cap < 1:
            raise ValueError(f"overlay cap must be >= 1, got {cap}")
        self.dag = dag
        self.n = dag.n
        self.cap = int(cap)
        self._rev = reverse_csr(dag)
        self.src = np.zeros(self.cap, dtype=np.int32)
        self.dst = np.zeros(self.cap, dtype=np.int32)
        self.n_edges = 0
        # nodes that reach >= 1 delta tail in the UNION graph (exact)
        self.can_reach_tail = np.zeros(self.n, dtype=bool)
        self.is_tail = np.zeros(self.n, dtype=bool)
        self.version = 0                      # bumped on every add batch
        self._edge_set: set = set()
        self._fwd: Dict[int, List[int]] = {}  # delta adjacency (host BFS)

    # ----------------------------------------------------------- capacity
    @property
    def free(self) -> int:
        return self.cap - self.n_edges

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """The applied delta edges (condensed ids), without padding."""
        return (self.src[: self.n_edges].copy(),
                self.dst[: self.n_edges].copy())

    # ------------------------------------------------------------- update
    def _in_base(self, a: int, b: int) -> bool:
        row = self.dag.neighbors(a)
        i = int(np.searchsorted(row, b))
        return i < row.size and int(row[i]) == b

    def add(self, src, dst) -> int:
        """Append a batch of condensed-id edges; returns how many were new.

        Self-edges and edges already present (in the base DAG or the
        overlay) are dropped. Raises :class:`OverlayFull` — without
        applying anything — if the surviving edges exceed the remaining
        capacity, so a failed add never leaves a partial batch behind.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be equal-length 1-D arrays")
        if src.size and (src.min() < 0 or src.max() >= self.n
                         or dst.min() < 0 or dst.max() >= self.n):
            raise ValueError("edge endpoint out of range")
        fresh = []
        seen_batch = set()
        for a, b in zip(src.tolist(), dst.tolist()):
            if a == b or (a, b) in seen_batch or (a, b) in self._edge_set \
                    or self._in_base(a, b):
                continue
            seen_batch.add((a, b))
            fresh.append((a, b))
        if not fresh:
            return 0
        if len(fresh) > self.free:
            raise OverlayFull(
                f"overlay holds {self.n_edges}/{self.cap} edges; batch "
                f"adds {len(fresh)} more — compact() first")
        lo = self.n_edges
        for i, (a, b) in enumerate(fresh):
            self.src[lo + i] = a
            self.dst[lo + i] = b
            self._edge_set.add((a, b))
            self._fwd.setdefault(a, []).append(b)
        self.n_edges = lo + len(fresh)
        new_tails = np.unique([a for a, _ in fresh])
        self._mark_ancestors(new_tails)
        self.is_tail[new_tails] = True
        self.version += 1
        return len(fresh)

    def _mark_ancestors(self, seeds: np.ndarray) -> None:
        """OR the union-graph ancestors of ``seeds`` (and the seeds) into
        ``can_reach_tail``.

        A fresh visited set per batch — NOT gated on already-marked nodes:
        a node marked for an earlier tail can sit on the reverse path from
        a new tail to still-unmarked ancestors, so the sweep must pass
        through it. Level-synchronous host BFS over the reverse base CSR
        plus the reverse delta slab, each level one vectorized gather
        (the reference loops over the level's nodes in Python; the visited
        set is the same).
        """
        visited = np.zeros(self.n, dtype=bool)
        visited[seeds] = True
        frontier = np.asarray(seeds, dtype=np.int64)
        indptr, indices = self._rev.indptr, self._rev.indices
        ne = self.n_edges
        dsrc, ddst = self.src[:ne], self.dst[:ne]
        while frontier.size:
            nxt = concat_rows(indptr, indices, frontier)
            # reverse delta step: edge (s, d) with d visited marks s
            if ne:
                sel = visited[ddst] & ~visited[dsrc]
                if sel.any():
                    nxt = np.concatenate([nxt, dsrc[sel]])
            nxt = np.unique(nxt)
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            frontier = nxt
        self.can_reach_tail |= visited

    # ----------------------------------------------------- host reference
    def host_reachable(self, s: int, t: int) -> bool:
        """Plain BFS over the union graph (condensed ids) — the terminal
        fallback when the device expansion overflows past its cap, and the
        oracle the property tests compare against."""
        if s == t:
            return True
        indptr, indices = self.dag.indptr, self.dag.indices
        seen = np.zeros(self.n, dtype=bool)
        seen[s] = True
        q = deque([int(s)])
        while q:
            u = q.popleft()
            row = indices[indptr[u]: indptr[u + 1]]
            for w_ in row:
                w = int(w_)
                if w == t:
                    return True
                if not seen[w]:
                    seen[w] = True
                    q.append(w)
            for w in self._fwd.get(u, ()):
                if w == t:
                    return True
                if not seen[w]:
                    seen[w] = True
                    q.append(w)
        return False

    # ------------------------------------------------------- device state
    def device_state(self, device) -> tuple:
        """(delta_src [cap] int32, delta_dst [cap] int32, can_reach_tail
        [n] bool, is_tail [n] bool) as tensors on ``device`` — fixed
        shapes; padding entries are (0, 0)."""
        return tuple(torch.from_numpy(a).to(device) for a in (
            self.src, self.dst, self.can_reach_tail, self.is_tail))

    def union_tail_state(self, tail_src, tail_dst, is_hub, out=None):
        """The union-graph expansion inputs from a base COO tail, on its
        device: (tail_src_u [m_t + cap], tail_dst_u [m_t + cap] int32, the
        delta slab after the base tail; is_hub_u: the hub mask extended
        to delta tails (``is_hub`` may be padded past n — only the first n
        rows change); can_reach_tail [n] bool, one byte a node, the
        overlay rule's gate).

        ``out``: the tuple an earlier call returned for the same base
        tail; its tensors are rewritten in place and returned, so every
        batch after the first keeps the same buffers (and ``data_ptr``).
        """
        m_t, dev = int(tail_src.shape[0]), tail_src.device
        if out is None:
            i32 = dict(dtype=torch.int32, device=dev)
            out = (torch.empty(m_t + self.cap, **i32),
                   torch.empty(m_t + self.cap, **i32),
                   torch.empty_like(is_hub),
                   torch.empty(self.n, dtype=torch.bool, device=dev))
            out[0][:m_t].copy_(tail_src)
            out[1][:m_t].copy_(tail_dst)
        tsrc_u, tdst_u, hub_u, crt = out
        dsrc, ddst, crt_now, is_tail = self.device_state(dev)
        tsrc_u[m_t:].copy_(dsrc)
        tdst_u[m_t:].copy_(ddst)
        hub_u.copy_(is_hub)
        hub_u[: self.n] |= is_tail
        crt.copy_(crt_now)
        return out
