"""QuerySession — the serving object of the ``repro_torch.reach`` facade.

Every incoming batch is padded up to a power-of-two *bucket* in
[min_bucket, max_batch], so a query stream of ragged sizes gives the
device a handful of batch shapes. Padding rows are (0, 0) self-queries:
they resolve in phase 1 by the [s] == [t] early-positive rule, never reach
phase 2, and their deterministic contribution is subtracted from the
session statistics.

``QuerySession.load(path)`` opens a session on a saved index artifact.
``submit()``/``drain()`` coalesce many small requests into full
micro-batches (capped at ``spec.max_batch``); ``stage()``/``begin()``/
``finish()`` split one batch into host→device copy, phase-1 launch and
phase 2, so a caller can stage batch N+1 while batch N classifies.

``apply_updates()`` inserts edges into the live graph (the engine's delta
overlay, ``reach.dynamic``) and ``compact()`` folds them into a new index;
a session bound to an artifact directory (``load``/``bind_artifact``) logs
every insert batch and saves every compacted epoch, and ``load`` replays
the log to the current graph.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.query import ResettableStats
from ..obs import register_stats, span
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
    # live-update path (reach.dynamic)
    n_updates: int = 0           # delta edges accepted into the overlay
    n_overlay_hits: int = 0      # base-NEG answers flipped POS by the overlay
    n_compactions: int = 0       # overlay folds into the index
    overlay_edges: int = 0       # current overlay fill (gauge, not counter)

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
    ids: object             # engine.stage_queries' StagedIds


@dataclass
class _InflightBatch:
    """A launched phase-1 batch awaiting ``QuerySession.finish``."""
    staged: _StagedBatch
    handle: object          # engine.start_answer handle
    t0: float


class QuerySession:
    """Serve reachability queries against one index, on one device or,
    under ``spec.placement`` "replicated" / "sharded", on every rank of a
    torch.distributed process group (each rank calls with the same
    batches and gets the whole answers; only rank 0 writes a bound
    artifact).

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
        self._n_inflight = 0          # begin() handles not yet finish()ed
        self.artifact_manifest: Optional[dict] = None   # set by load()
        self.epoch = 0                # graph epoch: bumped by compact()
        self._artifact_dir = None     # set by load(); enables delta logging
        # replay state (load()): not-yet-applied log batches + the tail of
        # the batch being applied — a replay-triggered compaction re-logs
        # both under the new epoch BEFORE committing its artifact, so no
        # durably-logged edge can be orphaned by a crash (DESIGN.md §6.3)
        self._replaying = False
        self._replay_pending: List[Tuple[np.ndarray, np.ndarray]] = []
        self._replay_tail = None
        self._next_delta_seq = None   # per-epoch log cursor (lazy-listed)
        self.reset_stats()
        # snapshot-time provider: the padded-query subtraction stays in
        # the ``stats`` property, the registry just reads through it
        register_stats("reach_session", self, provider=lambda s: s.stats)

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, path, spec: Optional[IndexSpec] = None,
             device="cuda") -> "QuerySession":
        """Open a session on ``device`` over a persisted index artifact
        (``reach.persist``), written by this package or the reference.

        ``spec`` overrides the spec stored with the artifact; the stored
        ELL layout is reused only when its width still matches. Edge
        inserts logged since the artifact's epoch replay into the overlay,
        so the session serves the CURRENT graph, and it stays bound to
        ``path``: later inserts append to its log.
        """
        from pathlib import Path

        from .persist import load_deltas, load_index
        art = load_index(path)
        saved_width = None if art.spec is None else art.spec.ell_width
        use_spec = spec if spec is not None else (art.spec or IndexSpec())
        ell = art.ell if use_spec.ell_width == saved_width else None
        sess = cls(art.index, use_spec, packed=art.packed, ell=ell,
                   device=device)
        sess.artifact_manifest = art.manifest
        sess.epoch = art.epoch
        sess._artifact_dir = Path(path)
        sess._replaying = True
        sess._replay_pending = load_deltas(path, art.epoch)
        try:
            while sess._replay_pending:
                src, dst = sess._replay_pending.pop(0)
                sess.apply_updates(src, dst)
        finally:
            sess._replaying = False
            sess._replay_pending = []
            sess._replay_tail = None
        return sess

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
        with span("stage", q=q, bucket=b):
            ids = self.engine.stage_queries(*self._pad(srcs, dsts, b))
        return _StagedBatch(q=q, bucket=b, ids=ids)

    def begin(self, staged: "_StagedBatch") -> "_InflightBatch":
        """Launch phase 1 on a staged batch without waiting for it. The
        handle is bound to the CURRENT engine: ``compact()`` refuses to
        run while any handle is outstanding."""
        t0 = time.perf_counter()
        with span("dispatch", bucket=staged.bucket):
            handle = self.engine.start_answer(staged.ids)
        self._n_inflight += 1
        return _InflightBatch(staged=staged, handle=handle, t0=t0)

    def finish(self, inflight: "_InflightBatch") -> np.ndarray:
        """Wait for a ``begin`` handle: phase 2 over the UNKNOWN residue,
        statistics, and the unpadded answers. Session counters account
        staged batches exactly like ``query()`` ones; ``seconds`` covers
        begin→finish wall time."""
        st = inflight.staged
        try:
            with span("finish", q=st.q, bucket=st.bucket):
                ans = self.engine.finish_answer(inflight.handle)[: st.q]
        finally:
            self._n_inflight -= 1
        self._seconds += time.perf_counter() - inflight.t0
        self._n_positive += int(ans.sum())
        self._n_padded += st.bucket - st.q
        self._n_batches += 1
        self._buckets[st.bucket] = self._buckets.get(st.bucket, 0) + 1
        return ans

    # -------------------------------------------------------- live updates
    @property
    def _writes_artifact(self) -> bool:
        """A bound session writes its log and epochs: one process of a
        multi-device session, rank 0, does."""
        mesh = getattr(self.engine, "mesh", None)
        return self._artifact_dir is not None and (mesh is None
                                                   or mesh.rank == 0)

    def bind_artifact(self, path, epoch: int = 0) -> None:
        """Attach this session to an index artifact directory so
        ``apply_updates`` appends to its delta log and ``compact``
        persists new epochs. ``QuerySession.load`` binds automatically;
        call this after a build-and-save so a freshly built session gets
        the same durability."""
        from pathlib import Path

        from .persist import load_manifest
        self._artifact_dir = Path(path)
        self.epoch = epoch
        # the log cursor belongs to the (dir, epoch) pair: force a re-list
        # so binding never overwrites batches already on disk there
        self._next_delta_seq = None
        if self.artifact_manifest is None:
            # carry the stored user_meta (graph identity): compact()
            # re-saves it on every later epoch
            self.artifact_manifest = load_manifest(path)

    def apply_updates(self, srcs, dsts) -> int:
        """Insert edges (ORIGINAL node ids) into the live graph.

        Answers reflect the inserts the moment this returns: edges land in
        the engine's delta overlay (capacity ``spec.overlay_cap``) and
        queries expand over the union graph. When a batch needs more room
        than the overlay has, ``compact()`` folds the overlay into the
        index first (``spec.auto_compact``; otherwise this raises
        ``OverlayFull`` and applies nothing). Bound sessions also append
        every batch to the artifact's delta log.

        Returns the number of NEW edges accepted (self-loops within an
        SCC and duplicates are dropped).
        """
        srcs = np.asarray(srcs, dtype=np.int64)
        dsts = np.asarray(dsts, dtype=np.int64)
        if srcs.shape != dsts.shape or srcs.ndim != 1:
            raise ValueError("srcs/dsts must be equal-length 1-D arrays")
        # validate BEFORE logging: a bad id must neither wrap through
        # negative indexing nor poison the delta log (a logged bad batch
        # would make every future load's replay raise)
        n_orig = self.index.cond.comp.shape[0]
        if srcs.size and (min(srcs.min(), dsts.min()) < 0
                          or max(srcs.max(), dsts.max()) >= n_orig):
            raise ValueError(
                f"edge endpoint out of range [0, {n_orig}) — updates take "
                "ORIGINAL node ids of the indexed graph")
        if not self.spec.auto_compact and not self._replaying:
            # all-or-nothing: DeltaOverlay.add raises OverlayFull before
            # mutating, so map the whole batch and apply it in one call;
            # log only after success
            comp = self.index.cond.comp
            ca, cb = comp[srcs], comp[dsts]
            keep = ca != cb
            applied = self.engine.apply_updates(ca[keep], cb[keep])
            if self._writes_artifact:
                from .persist import append_delta
                append_delta(self._artifact_dir, self.epoch, srcs, dsts,
                             seq=self._take_delta_seq())
            return applied
        applied = 0
        lo = 0
        while lo < srcs.size:
            if self._replaying:
                self._replay_tail = (srcs[lo:], dsts[lo:])
            ov = self.engine.overlay
            free = self.engine.overlay_cap if ov is None else ov.free
            if free == 0:
                self._auto_compact()
                continue
            hi = min(lo + free, srcs.size)
            s, d = srcs[lo:hi], dsts[lo:hi]
            # chunks log BEFORE applying; replayed batches never re-log
            # here — they are already durable under the artifact's epoch,
            # and a replay-triggered compaction re-logs the unfolded rest
            # under its new epoch itself (see compact())
            if self._writes_artifact and not self._replaying:
                from .persist import append_delta
                append_delta(self._artifact_dir, self.epoch, s, d,
                             seq=self._take_delta_seq())
            comp = self.index.cond.comp
            ca, cb = comp[s], comp[d]
            keep = ca != cb          # same-SCC edges change nothing
            applied += self.engine.apply_updates(ca[keep], cb[keep])
            lo = hi
        if self._replaying:
            self._replay_tail = None
        return applied

    def _take_delta_seq(self) -> int:
        """Next sequence number in the current epoch's delta log — listed
        from disk once, then counted in memory."""
        if self._next_delta_seq is None:
            from .persist import next_delta_seq
            self._next_delta_seq = next_delta_seq(self._artifact_dir,
                                                  self.epoch)
        seq = self._next_delta_seq
        self._next_delta_seq += 1
        return seq

    def _auto_compact(self) -> None:
        if not self.spec.auto_compact:
            from .dynamic import OverlayFull
            raise OverlayFull(
                f"overlay full ({self.spec.overlay_cap} edges) and "
                "auto_compact is off — call session.compact()")
        self.compact()

    def compact(self, mode: Optional[str] = None):
        """Fold the delta overlay into the index (bounded incremental
        relabeling — ``reach.dynamic.compact_index``), on the engine's
        device.

        Recomputes only the labels of union-graph ancestors of the
        inserted tails, re-running the staged device pipeline over the
        affected waves (kernel 5 on a card); falls back to a full rebuild
        when an insert closed a cycle (``mode`` defaults to
        ``spec.compact_mode``). The engine is rebuilt on the new index on
        the same device — same spec, fresh packed layouts — with the
        cumulative phase counters carried over. Bound sessions persist the
        new index under the bumped epoch. Returns the new index's
        BuildStats.
        """
        if self._n_inflight:
            # a begin() handle holds phase-1 verdicts computed against the
            # CURRENT engine/condensation; swapping the engine under it
            # would misread condensed ids against the rebuilt index
            raise RuntimeError(
                f"compact() with {self._n_inflight} staged phase-1 "
                "handle(s) outstanding — finish() them first")
        from ..core.packed import pack_index
        from .dynamic import compact_index
        device = self.engine.device
        ov = self.engine.overlay
        esrc, edst = (ov.edges() if ov is not None
                      else (np.zeros(0, np.int32), np.zeros(0, np.int32)))
        new_ix = compact_index(self.index, esrc, edst, self.spec,
                               mode=mode or self.spec.compact_mode,
                               device=device)
        pk = pack_index(new_ix)
        # pack the ELL layout once and share it between the fresh engine
        # and the re-saved artifact
        p2 = self.spec.phase2_mode
        if p2 == "auto":
            p2 = ("sparse" if self.spec.placement != "single"
                  else "dense" if pk.n <= self.spec.n_dense_max else "sparse")
        ell = (pk.ell_layout(width=self.spec.ell_width)
               if self._artifact_dir is not None or p2 == "sparse" else None)
        stats = self.engine.stats           # carry phase mix across the swap
        self.index = new_ix
        # a multi-device engine keeps its mesh (and process groups)
        self.engine = make_engine(new_ix, self.spec, packed=pk, ell=ell,
                                  device=device,
                                  mesh=getattr(self.engine, "mesh", None))
        self.engine.stats = stats
        self.engine.stats.n_compactions += 1
        self.epoch += 1
        self._next_delta_seq = 0     # fresh epoch — fresh log cursor
        if self._writes_artifact:
            from .persist import append_delta, save_index
            if self._replaying:
                # a compaction mid-replay folds only the already-replayed
                # prefix: re-log the in-flight batch tail and the pending
                # log batches under the NEW epoch BEFORE committing its
                # artifact (log-then-commit, DESIGN.md §6.3): before the
                # commit the old epoch and its complete log win, after it
                # the new epoch's log holds its complete tail
                if self._replay_tail is not None \
                        and self._replay_tail[0].size:
                    append_delta(self._artifact_dir, self.epoch,
                                 *self._replay_tail,
                                 seq=self._take_delta_seq())
                for s2, d2 in self._replay_pending:
                    append_delta(self._artifact_dir, self.epoch, s2, d2,
                                 seq=self._take_delta_seq())
            meta = None
            if self.artifact_manifest is not None:
                meta = self.artifact_manifest["extra"].get("user_meta")
            save_index(self._artifact_dir, new_ix, self.spec, meta=meta,
                       packed=pk, ell=ell, epoch=self.epoch)
        return new_ix.stats

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
            n_updates=es.n_updates,
            n_overlay_hits=es.n_overlay_hits,
            n_compactions=es.n_compactions,
            overlay_edges=(0 if self.engine.overlay is None
                           else self.engine.overlay.n_edges),
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
