"""QuerySession — the serving object of the ``repro_torch.reach`` facade.

Every incoming batch is padded up to a power-of-two *bucket* in
[min_bucket, max_batch], so a query stream of ragged sizes gives the
device a handful of batch shapes. Padding rows are (0, 0) self-queries:
they resolve in phase 1 by the [s] == [t] early-positive rule, never reach
phase 2, and their deterministic contribution is subtracted from the
session statistics.

``submit()``/``drain()`` coalesce many small requests into full
micro-batches (capped at ``spec.max_batch``); ``stage()``/``begin()``/
``finish()`` split one batch into host→device copy, phase-1 launch and
phase 2, so a caller can stage batch N+1 while batch N classifies.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.query import ResettableStats
from .spec import IndexSpec, make_engine


@dataclass
class SessionStats(ResettableStats):
    """Unified serving statistics (phase mix + batching behaviour)."""
    n_queries: int = 0
    n_positive: int = 0
    # phase mix (from the device engine)
    phase1_pos: int = 0
    phase1_neg: int = 0
    phase2_queries: int = 0
    phase2_dense: int = 0
    phase2_sparse: int = 0
    phase2_host: int = 0
    sparse_retries: int = 0
    host_nodes_expanded: int = 0
    # micro-batching behaviour (session level)
    n_batches: int = 0
    n_padded: int = 0
    seconds: float = 0.0
    buckets: Dict[int, int] = field(default_factory=dict)

    @property
    def ns_per_query(self) -> float:
        return 0.0 if not self.n_queries else self.seconds / self.n_queries * 1e9

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["ns_per_query"] = self.ns_per_query
        return d


@dataclass
class _StagedBatch:
    """A padded batch whose host→device transfer is in flight."""
    q: int                  # real (unpadded) query count
    bucket: int             # padded power-of-two bucket
    srcs: object            # staged tensors (engine.stage_queries)
    dsts: object


@dataclass
class _InflightBatch:
    """A launched phase-1 batch awaiting ``QuerySession.finish``."""
    staged: _StagedBatch
    handle: object          # engine.start_answer handle
    t0: float


class QuerySession:
    """Serve reachability queries against one index on one device.

    >>> sess = QuerySession(index, spec)          # device="cuda" by default
    >>> ans = sess.query(srcs, dsts)              # bucketed micro-batches
    >>> t = sess.submit(srcs, dsts); sess.drain() # queued micro-batching
    """

    def __init__(self, index, spec: Optional[IndexSpec] = None, *,
                 packed=None, ell=None, engine=None, device="cuda"):
        self.spec = spec if spec is not None else IndexSpec()
        self.index = index
        self.engine = (engine if engine is not None
                       else make_engine(index, self.spec, packed=packed,
                                        ell=ell, device=device))
        self._pending: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self._next_ticket = 0
        self.reset_stats()

    # ------------------------------------------------------------ querying
    def query(self, srcs, dsts) -> np.ndarray:
        """Answer a batch of original-id query pairs, micro-batched and
        padded to power-of-two buckets."""
        srcs = np.asarray(srcs)
        dsts = np.asarray(dsts)
        if srcs.shape != dsts.shape or srcs.ndim != 1:
            raise ValueError("srcs/dsts must be equal-length 1-D arrays")
        n = srcs.size
        out = np.empty(n, dtype=bool)
        t0 = time.perf_counter()
        for lo in range(0, n, self.spec.max_batch):
            hi = min(lo + self.spec.max_batch, n)
            out[lo:hi] = self._answer_bucketed(srcs[lo:hi], dsts[lo:hi])
        self._seconds += time.perf_counter() - t0
        self._n_positive += int(out.sum())
        return out

    def _bucket(self, q: int) -> int:
        b = self.spec.min_bucket
        while b < q:
            b <<= 1
        return min(b, self.spec.max_batch)

    def _pad(self, s: np.ndarray, t: np.ndarray, b: int):
        q = s.size
        if q == b:
            return s, t
        ps = np.zeros(b, dtype=np.int64)
        pt = np.zeros(b, dtype=np.int64)
        ps[:q] = s
        pt[:q] = t
        return ps, pt

    def _answer_bucketed(self, s: np.ndarray, t: np.ndarray) -> np.ndarray:
        q = s.size
        b = self._bucket(q)
        ans = self.engine.answer(*self._pad(s, t, b))[:q]
        self._n_padded += b - q
        self._n_batches += 1
        self._buckets[b] = self._buckets.get(b, 0) + 1
        return ans

    # ------------------------------------------------------- queue serving
    def submit(self, srcs, dsts) -> int:
        """Enqueue a request; returns a ticket for ``drain()``'s result map."""
        srcs = np.asarray(srcs)
        dsts = np.asarray(dsts)
        if srcs.shape != dsts.shape or srcs.ndim != 1:
            raise ValueError("srcs/dsts must be equal-length 1-D arrays")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, srcs, dsts))
        return ticket

    @property
    def pending_queries(self) -> int:
        return sum(s.size for _, s, _ in self._pending)

    def drain(self) -> Dict[int, np.ndarray]:
        """Answer every pending request in one coalesced bucketed stream.
        Returns {ticket: answers}."""
        if not self._pending:
            return {}
        reqs, self._pending = self._pending, []
        cat_s = np.concatenate([s for _, s, _ in reqs])
        cat_t = np.concatenate([t for _, _, t in reqs])
        ans = self.query(cat_s, cat_t)
        out: Dict[int, np.ndarray] = {}
        lo = 0
        for ticket, s, _ in reqs:
            out[ticket] = ans[lo: lo + s.size]
            lo += s.size
        return out

    # ---------------------------------------------- staged (pipelined) path
    def stage(self, srcs, dsts) -> "_StagedBatch":
        """Pad one batch to its power-of-two bucket and start its
        host→device copy. ``begin`` launches phase 1 without waiting and
        ``finish`` waits and runs phase 2, so staging batch N+1 overlaps
        the device classifying batch N. A staged batch holds at most one
        bucket (``spec.max_batch``)."""
        srcs = np.asarray(srcs)
        dsts = np.asarray(dsts)
        if srcs.shape != dsts.shape or srcs.ndim != 1:
            raise ValueError("srcs/dsts must be equal-length 1-D arrays")
        q = srcs.size
        if q > self.spec.max_batch:
            raise ValueError(f"staged batch of {q} exceeds max_batch="
                             f"{self.spec.max_batch}; chop it first")
        b = self._bucket(max(q, 1))
        cs, ct = self.engine.stage_queries(*self._pad(srcs, dsts, b))
        return _StagedBatch(q=q, bucket=b, srcs=cs, dsts=ct)

    def begin(self, staged: "_StagedBatch") -> "_InflightBatch":
        """Launch phase 1 on a staged batch without waiting for it."""
        t0 = time.perf_counter()
        handle = self.engine.start_answer(staged.srcs, staged.dsts)
        return _InflightBatch(staged=staged, handle=handle, t0=t0)

    def finish(self, inflight: "_InflightBatch") -> np.ndarray:
        """Wait for a ``begin`` handle: phase 2 over the UNKNOWN residue,
        statistics, and the unpadded answers. Session counters account
        staged batches exactly like ``query()`` ones; ``seconds`` covers
        begin→finish wall time."""
        st = inflight.staged
        ans = self.engine.finish_answer(inflight.handle)[: st.q]
        self._seconds += time.perf_counter() - inflight.t0
        self._n_positive += int(ans.sum())
        self._n_padded += st.bucket - st.q
        self._n_batches += 1
        self._buckets[st.bucket] = self._buckets.get(st.bucket, 0) + 1
        return ans

    # ------------------------------------------------------------- warmup
    def warmup(self, *batch_sizes: int) -> None:
        """Run the buckets the given batch sizes map to (with (0, 0)
        self-queries), then clear statistics. Each size expands to its
        full-chunk bucket plus its ragged-tail bucket, deduplicated."""
        seen = set()
        for sz in batch_sizes:
            if sz <= 0:
                continue
            full, tail = divmod(sz, self.spec.max_batch)
            for b in ([self.spec.max_batch] if full else []) + \
                    ([self._bucket(tail)] if tail else []):
                if b in seen:
                    continue
                seen.add(b)
                z = np.zeros(b, dtype=np.int64)
                self.query(z, z)
        self.reset_stats()

    # ------------------------------------------------------------- stats
    @property
    def trace_count(self) -> int:
        """Distinct phase-1 batch shapes so far (one per bucket after
        warmup — growth past that means shape churn)."""
        return self.engine.trace_count

    @property
    def stats(self) -> SessionStats:
        es = self.engine.stats
        host = self.engine._host_engine
        # padding rows are (0, 0) self-queries: each is exactly one
        # phase-1 POS, so their contribution subtracts deterministically
        return SessionStats(
            n_queries=es.n_queries - self._n_padded,
            n_positive=self._n_positive,
            phase1_pos=es.phase1_pos - self._n_padded,
            phase1_neg=es.phase1_neg,
            phase2_queries=es.phase2_queries,
            phase2_dense=es.phase2_dense,
            phase2_sparse=es.phase2_sparse,
            phase2_host=es.phase2_host,
            sparse_retries=es.sparse_retries,
            host_nodes_expanded=(0 if host is None
                                 else host.stats.nodes_expanded),
            n_batches=self._n_batches,
            n_padded=self._n_padded,
            seconds=self._seconds,
            buckets=dict(self._buckets),
        )

    def reset_stats(self) -> None:
        """Clear all serving statistics (engine + session)."""
        self.engine.stats.reset()
        if self.engine._host_engine is not None:
            self.engine._host_engine.stats.reset()
        self._n_positive = 0
        self._n_batches = 0
        self._n_padded = 0
        self._seconds = 0.0
        self._buckets: Dict[int, int] = {}
