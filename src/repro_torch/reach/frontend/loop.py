"""Deadline-aware coalescing loop — the frontend's dispatch engine.

``Frontend`` sits in front of a ``QuerySession`` (DESIGN.md §7) and turns
many small multi-tenant requests into few full device slabs:

  * requests enter through the :class:`~.router.QueryRouter` (bounded
    per-tenant queues, admission control, reject-with-reason);
  * the **answer cache** (:class:`~.cache.AnswerCache`) is probed at
    submit: fully-cached requests complete immediately without touching a
    queue or the device, partial hits enqueue only their misses;
  * a slab is cut when the pending pool fills a batch bucket OR the
    oldest request's per-tenant deadline fires — latency-bounded
    coalescing instead of wait-forever batching;
  * slabs are **double-buffered**: each ``poll()`` stages slab N+1's
    host→device transfer (``QuerySession.stage``) before blocking on slab
    N (``finish``), so staging overlaps classification. On a card the
    engine copies a slab's ids from one of two reused pinned host buffers
    without waiting, and a buffer returns to the pool only when its slab
    is finished (``core.query_torch.PinnedIds``).

The loop is cooperative: callers (``launch/serve.py``, a request handler
thread...) call ``poll()`` whenever they have cycles — there is no
background thread contending for the GIL. ``drain()`` runs the loop to
empty for closed-loop use.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ...obs import SlowLog, get_registry, get_tracer, register_stats, span
from .cache import AnswerCache
from .router import QueryRouter, Rejected, Request  # noqa: F401 (re-export)
from .stats import FrontendStats, LatencyTrack, TenantSnapshot


@dataclass
class _Cut:
    """One assembled slab moving through the double buffer."""
    reqs: List[Request]
    staged: object              # QuerySession._StagedBatch
    version: tuple              # graph version the slab is computed under
    q: int                      # real queries in the slab
    t_assemble: float = 0.0     # clock() when the slab was cut
    stage_s: float = 0.0        # host->device staging wall time


def _pow2ceil(x: int) -> int:
    b = 1
    while b < x:
        b <<= 1
    return b


class Frontend:
    """Multi-tenant deadline-aware serving front-end over a QuerySession.

    >>> fe = Frontend(sess)                      # knobs from sess.spec
    >>> t = fe.submit("tenant-a", srcs, dsts)    # may raise Rejected
    >>> fe.poll()                                # drive the loop
    >>> answers = fe.results().get(t)            # when completed
    >>> fe.stats.as_dict()                       # FrontendStats snapshot

    Knobs default from ``session.spec`` (``deadline_us``,
    ``tenant_queue_cap``, ``cache_entries``); ``batch_target`` is the
    slab-cut threshold in queries (default ``spec.max_batch``);
    ``service_hint_us`` seeds the slab-service EWMA (see below);
    ``clock`` is injectable for deterministic tests.
    """

    # the deadline flush leads by EWMA_LEAD_SAFETY x the slab-service
    # EWMA: leading by exactly one service time would aim completions AT
    # the deadline, where any jitter is a miss — the margin turns the
    # expected completion into "comfortably before"
    EWMA_LEAD_SAFETY = 1.5

    def __init__(self, session, *, deadline_us: Optional[float] = None,
                 tenant_queue_cap: Optional[int] = None,
                 cache_entries: Optional[int] = None,
                 batch_target: Optional[int] = None,
                 service_hint_us: Optional[float] = None,
                 clock=time.perf_counter):
        spec = session.spec
        self.session = session
        self.clock = clock
        self.batch_target = min(spec.max_batch,
                                batch_target or spec.max_batch)
        if self.batch_target < 1:
            raise ValueError("batch_target must be >= 1")
        self.router = QueryRouter(
            queue_cap=(spec.tenant_queue_cap if tenant_queue_cap is None
                       else tenant_queue_cap),
            deadline_s=(spec.deadline_us if deadline_us is None
                        else deadline_us) * 1e-6,
            max_request=spec.max_batch)
        entries = (spec.cache_entries if cache_entries is None
                   else cache_entries)
        n_orig = session.index.cond.comp.shape[0]
        self.cache = (AnswerCache(entries, n_orig) if entries > 0 else None)
        self._next_ticket = 0
        self._completed: Dict[int, np.ndarray] = {}
        self._staged: Optional[_Cut] = None     # H2D in flight
        self._inflight: Optional[tuple] = None  # (cut, handle, t_begin)
        # EWMA of slab service time: the deadline flush leads by this
        # much so a request can complete BY its deadline, not start at
        # it. ``service_hint_us`` seeds it (warm restarts, or a measured
        # floor) so the first slab is not scheduled as if it were free.
        self._service_ewma = (service_hint_us or 0.0) * 1e-6
        self._ewma_primed = service_hint_us is not None
        self._acc: Dict[str, dict] = {}
        # slab accounting (FrontendStats)
        self._n_batches = 0
        self._batch_queries = 0
        self._batch_slots = 0
        self._occupancy_hist: Dict[int, int] = {}
        self._deadline_flushes = 0
        self._full_flushes = 0
        self._forced_flushes = 0
        # telemetry (obs, DESIGN.md §8): the slow-slab/deadline-miss
        # ring log is always on (its inputs are clock reads the EWMA takes
        # anyway); the histograms share the process registry so a
        # --metrics-dump carries them; the stats view is weakly held
        self._lat_cap = spec.latency_window
        self.slowlog = SlowLog()
        reg = get_registry()
        self._h_service = reg.histogram(
            "frontend_slab_service_seconds",
            "begin->finish wall time per device slab")
        self._h_queue_wait = reg.histogram(
            "frontend_queue_wait_seconds",
            "submit->slab-assembly wait per request")
        register_stats("reach_frontend", self,
                       provider=lambda fe: fe._flat_stats())

    # ------------------------------------------------------------- tenants
    def register_tenant(self, name: str, *,
                        deadline_us: Optional[float] = None,
                        queue_cap: Optional[int] = None) -> None:
        """Pre-register a tenant with per-tenant deadline/capacity
        overrides; unseen tenants auto-register with the defaults."""
        self.router.register(name, queue_cap=queue_cap,
                             deadline_us=deadline_us)
        self._ensure_acc(name)

    def _ensure_acc(self, name: str) -> dict:
        acc = self._acc.get(name)
        if acc is None:
            acc = {"requests": 0, "queries": 0, "completed": 0,
                   "deadline_misses": 0, "short_circuits": 0,
                   "lat": LatencyTrack(self._lat_cap)}
            self._acc[name] = acc
        return acc

    def _graph_version(self) -> tuple:
        """(epoch, overlay version): bumped by compact() AND by every
        apply_updates batch — the cache invalidation token (an insert can
        flip NEG→POS without an epoch bump, so epoch alone is not enough)."""
        ov = self.session.engine.overlay
        return (self.session.epoch, 0 if ov is None else ov.version)

    # -------------------------------------------------------------- ingress
    def submit(self, tenant: str, srcs, dsts) -> int:
        """Admit one request; returns its ticket. Raises
        :class:`~.router.Rejected` (reason ``queue_full`` /
        ``too_large``) under backpressure — the request is NOT queued."""
        srcs = np.asarray(srcs, dtype=np.int64)
        dsts = np.asarray(dsts, dtype=np.int64)
        if srcs.shape != dsts.shape or srcs.ndim != 1:
            raise ValueError("srcs/dsts must be equal-length 1-D arrays")
        now = self.clock()
        tq = self.router.register(tenant)
        acc = self._ensure_acc(tenant)
        ticket = self._next_ticket
        n = srcs.size
        answers = np.zeros(n, dtype=bool)
        hit = None
        if self.cache is not None and n:
            # peek, don't count: a request the router then rejects must
            # leave no trace in hit_rate or LRU recency — the probe is
            # committed only once the request is accepted (or completes)
            with span("cache_probe", tenant=tenant, n=int(n)):
                c_ans, hit = self.cache.lookup(self._graph_version(), srcs,
                                               dsts, commit=False)
            answers[hit] = c_ans[hit]
            pending = np.flatnonzero(~hit)
        else:
            pending = np.arange(n)
        if pending.size == 0:
            # every pair answered from the cache (or an empty request):
            # complete without touching a queue or the device
            if hit is not None:
                self.cache.commit_probe(srcs, dsts, hit)
            self._next_ticket += 1
            acc["requests"] += 1
            acc["queries"] += n
            acc["completed"] += 1
            acc["short_circuits"] += 1 if n else 0
            acc["lat"].add(self.clock() - now)
            self._completed[ticket] = answers
            return ticket
        req = Request(ticket=ticket, tenant=tenant, srcs=srcs, dsts=dsts,
                      t_submit=now, deadline=now + tq.deadline_s,
                      answers=answers, pending=pending)
        self.router.admit(req)              # raises Rejected on backpressure
        if hit is not None:
            self.cache.commit_probe(srcs, dsts, hit)
        self._next_ticket += 1
        acc["requests"] += 1
        acc["queries"] += n
        return ticket

    # ----------------------------------------------------------- the loop
    def _flush_reason(self, now: float, force: bool) -> Optional[str]:
        if self.router.pending_queries == 0:
            return None
        if self.router.pending_queries >= self.batch_target:
            return "full"
        head = self.router.oldest_deadline()
        if (head is not None
                and head - self.EWMA_LEAD_SAFETY * self._service_ewma
                <= now):
            return "deadline"
        return "forced" if force else None

    def next_deadline(self) -> Optional[float]:
        """Absolute time the oldest pending request must FLUSH by (None
        when idle) — its deadline minus the slab-service EWMA, so open-loop
        drivers that sleep/fast-forward to this still complete it on
        time."""
        head = self.router.oldest_deadline()
        if head is None:
            return None
        return head - self.EWMA_LEAD_SAFETY * self._service_ewma

    def poll(self, now: Optional[float] = None, force: bool = False) -> int:
        """One turn of the coalescing loop; returns requests completed.

        Order is the double buffer: (1) if a flush is due, assemble the
        next slab and start its host→device staging; (2) block-finish the
        in-flight slab — its phase 2 overlaps (1)'s transfer; (3) dispatch
        the staged slab's phase 1 and return. ``now`` defaults to
        ``clock()`` and also timestamps completions; ``force`` flushes
        regardless of fill/deadline (drain)."""
        if now is None:
            now = self.clock()
        if self._staged is None:
            reason = self._flush_reason(now, force)
            if reason is not None:
                self._assemble(reason)
        done = 0
        if self._inflight is not None:
            done = self._finish()
        if self._staged is not None:
            cut = self._staged
            self._staged = None
            # the slab's lifetime span is explicit begin/end on its own
            # parity track: it OVERLAPS the next slab's staging, so it
            # must neither use the implicit span stack nor share a track
            # with its neighbour (obs.trace)
            seq = self._n_batches
            tok = get_tracer().begin("slab", track=f"slab-{seq % 2}",
                                     slab=seq, q=cut.q)
            # re-read the clock at dispatch: _finish() above may have
            # blocked on the previous slab, and the service EWMA must
            # measure THIS slab's begin->finish time, not the prior
            # slab's phase 2 plus the inter-poll gap (an inflated EWMA
            # over-leads the deadline flush, shrinking batches)
            self._inflight = (cut, self.session.begin(cut.staged),
                              self.clock(), tok)
        return done

    @property
    def busy(self) -> bool:
        """True while any slab is staged or in flight (open-loop drivers
        combine this with ``router.pending_queries`` to know when idle)."""
        return self._staged is not None or self._inflight is not None

    def drain(self) -> Dict[int, np.ndarray]:
        """Run the loop until nothing is pending, staged or in flight,
        then return (and clear) all completed results."""
        while self.router.pending_queries or self.busy:
            self.poll(force=True)
        return self.results()

    def results(self) -> Dict[int, np.ndarray]:
        """Pop every completed {ticket: answers}."""
        out, self._completed = self._completed, {}
        return out

    def query(self, tenant: str, srcs, dsts) -> np.ndarray:
        """Synchronous convenience: submit + drain + return this
        request's answers (other tickets stay in ``results()``)."""
        t = self.submit(tenant, srcs, dsts)
        while t not in self._completed:
            self.poll(force=True)
        return self._completed.pop(t)

    # ------------------------------------------------------------ internals
    def _assemble(self, reason: str) -> None:
        reqs = self.router.take_batch(self.batch_target)
        if not reqs:
            return
        t_a = self.clock()
        tr = get_tracer()
        for r in reqs:
            wait = max(0.0, t_a - r.t_submit)
            self._h_queue_wait.observe(wait)
            if tr.enabled:
                # retroactive: the span is reconstructed from the submit
                # timestamp the request already carries
                tr.record("queue_wait", r.t_submit, wait, track="requests",
                          ticket=r.ticket, tenant=r.tenant)
        with span("coalesce", reason=reason, n_reqs=len(reqs)):
            cat_s = np.concatenate([r.srcs[r.pending] for r in reqs])
            cat_t = np.concatenate([r.dsts[r.pending] for r in reqs])
            staged = self.session.stage(cat_s, cat_t)  # H2D starts
        stage_s = max(0.0, self.clock() - t_a)
        self._staged = _Cut(reqs=reqs, staged=staged,
                            version=self._graph_version(), q=cat_s.size,
                            t_assemble=t_a, stage_s=stage_s)
        if reason == "deadline":
            self._deadline_flushes += 1
        elif reason == "full":
            self._full_flushes += 1
        else:
            self._forced_flushes += 1

    def _finish(self) -> int:
        cut, handle, t_begin, slab_tok = self._inflight
        self._inflight = None
        ans = self.session.finish(handle)
        # re-read the clock: finish() blocked, and latencies/misses must
        # include that device time, not the poll()-entry timestamp
        now = self.clock()
        dt = max(0.0, now - t_begin)
        tr = get_tracer()
        tr.end(slab_tok)
        self._h_service.observe(dt)
        self._service_ewma = (dt if not self._ewma_primed
                              else 0.7 * self._service_ewma + 0.3 * dt)
        self._ewma_primed = True
        misses = 0
        lo = 0
        for req in cut.reqs:
            k = req.pending.size
            sub = ans[lo: lo + k]
            lo += k
            req.answers[req.pending] = sub
            if self.cache is not None:
                # version-guarded: a slab that raced an update/compact
                # must not seed the new graph's cache with old answers
                self.cache.insert(cut.version, req.srcs[req.pending],
                                  req.dsts[req.pending], sub)
            self._completed[req.ticket] = req.answers
            acc = self._acc[req.tenant]
            acc["completed"] += 1
            acc["lat"].add(now - req.t_submit)
            if now > req.deadline:
                acc["deadline_misses"] += 1
                misses += 1
                tr.instant("deadline_miss", ticket=req.ticket,
                           tenant=req.tenant,
                           late_us=(now - req.deadline) * 1e6)
        eng = self.session.engine
        self.slowlog.observe_slab(
            slab=self._n_batches, service_s=dt, n_queries=cut.q,
            deadline_misses=misses,
            breakdown={"stage": cut.stage_s,
                       "phase1": eng.last_phase1_s,
                       "phase2": eng.last_phase2_s})
        self._n_batches += 1
        self._batch_queries += cut.q
        self._batch_slots += cut.staged.bucket
        b = _pow2ceil(max(cut.q, 1))
        self._occupancy_hist[b] = self._occupancy_hist.get(b, 0) + 1
        return len(cut.reqs)

    # ---------------------------------------------------------- live graph
    def _quiesce(self) -> None:
        """Finish any staged/in-flight slab before a graph mutation.

        A slab is bound to the engine that staged it: ``compact()`` swaps
        the engine AND the condensation, so finishing an old handle
        against the new engine would misread condensed ids and treat
        old-epoch phase-1 base-NEG verdicts as final (the new engine has
        no overlay) — silently wrong answers, not merely stale ones. The
        double buffer must therefore run dry before the swap; queued
        requests that have not been cut into a slab yet are fine — they
        dispatch later, against the post-mutation engine."""
        while self.busy:
            self.poll()

    def apply_updates(self, srcs, dsts) -> int:
        """Insert edges through the session. Quiesces the double buffer
        first: an overlay-full batch can auto-compact, which swaps the
        engine under any in-flight slab (see :meth:`_quiesce`). The graph
        version token changes with the overlay (and with any
        auto-compaction), so the answer cache invalidates wholesale on
        the next probe — a cached answer is never served across a
        mutation (DESIGN.md §7)."""
        self._quiesce()
        return self.session.apply_updates(srcs, dsts)

    def compact(self, mode: Optional[str] = None):
        """Fold the overlay (epoch bump → wholesale cache invalidation).
        Quiesces the double buffer first — in-flight slabs finish on the
        engine that dispatched them (see :meth:`_quiesce`)."""
        self._quiesce()
        return self.session.compact(mode)

    # -------------------------------------------------------------- stats
    @property
    def stats(self) -> FrontendStats:
        def us(v):               # empty latency window -> None, not 0-bias
            return None if v is None else v * 1e6

        tenants = {}
        for name, acc in self._acc.items():
            tq = self.router.tenants.get(name)
            lat = acc["lat"]
            tenants[name] = TenantSnapshot(
                requests=acc["requests"], queries=acc["queries"],
                completed=acc["completed"],
                rejected=dict(self.router.rejections.get(name, {})),
                deadline_misses=acc["deadline_misses"],
                cache_short_circuits=acc["short_circuits"],
                queue_hiwater=0 if tq is None else tq.hiwater,
                p50_us=us(lat.percentile(50)),
                p99_us=us(lat.percentile(99)),
                mean_us=us(lat.mean))
        return FrontendStats(
            tenants=tenants,
            n_batches=self._n_batches,
            batch_queries=self._batch_queries,
            batch_slots=self._batch_slots,
            occupancy_hist=dict(self._occupancy_hist),
            deadline_flushes=self._deadline_flushes,
            full_flushes=self._full_flushes,
            forced_flushes=self._forced_flushes,
            cache=None if self.cache is None else self.cache.as_dict())

    def _flat_stats(self) -> dict:
        """Numeric-only view for the metrics registry (register_stats):
        the nested TenantSnapshot/cache dicts are summed flat so every
        sample is a plain ``reach_frontend_<field>`` number."""
        out = {
            "n_batches": self._n_batches,
            "batch_queries": self._batch_queries,
            "batch_slots": self._batch_slots,
            "deadline_flushes": self._deadline_flushes,
            "full_flushes": self._full_flushes,
            "forced_flushes": self._forced_flushes,
            "requests": sum(a["requests"] for a in self._acc.values()),
            "completed": sum(a["completed"] for a in self._acc.values()),
            "deadline_misses": sum(a["deadline_misses"]
                                   for a in self._acc.values()),
            "cache_short_circuits": sum(a["short_circuits"]
                                        for a in self._acc.values()),
        }
        if self.cache is not None:
            out["cache_hits"] = self.cache.hits
            out["cache_misses"] = self.cache.misses
            out["cache_evictions"] = self.cache.evictions
            out["cache_invalidations"] = self.cache.invalidations
        return out
