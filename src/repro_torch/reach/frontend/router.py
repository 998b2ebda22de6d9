"""Query router: per-tenant bounded queues, admission control, backpressure.

The router is the frontend's ingress (DESIGN.md §7). Every tenant owns a
bounded FIFO of pending *requests* (a request = one ``submit()`` batch of
query pairs). Admission is all-or-nothing per request and rejects with a
reason instead of growing without bound:

  ``too_large``   the request alone exceeds the tenant's queue capacity
                  (or the session's ``max_batch`` — it could never be
                  dispatched in one slab);
  ``queue_full``  the tenant's pending queries + the request would exceed
                  its capacity — classic backpressure: the caller backs
                  off or sheds load, the serving loop never OOMs.

Batch assembly (``take_batch``) drains requests round-robin across
tenants, starting after the last tenant served, so one chatty tenant
cannot starve the rest — whole requests only, keeping each request's
answers contiguous in the slab.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

REJECT_REASONS = ("too_large", "queue_full")


class Rejected(RuntimeError):
    """Admission-control rejection; ``reason`` is one of REJECT_REASONS."""

    def __init__(self, reason: str, tenant: str, detail: str = ""):
        super().__init__(f"request rejected ({reason}) for tenant "
                         f"{tenant!r}{': ' + detail if detail else ''}")
        self.reason = reason
        self.tenant = tenant


@dataclass
class Request:
    """One submitted batch, tracked from admission to completion."""
    ticket: int
    tenant: str
    srcs: np.ndarray            # original-id query pairs (full request)
    dsts: np.ndarray
    t_submit: float             # clock() at admission
    deadline: float             # t_submit + tenant deadline
    answers: np.ndarray         # [n] bool; cache hits pre-filled at submit
    pending: np.ndarray         # indices still needing the device (misses)


@dataclass
class TenantQueue:
    """Bounded FIFO of admitted requests for one tenant."""
    name: str
    queue_cap: int              # max pending queries (not requests)
    deadline_s: float           # coalescing deadline, seconds
    queue: deque = field(default_factory=deque)
    fill: int = 0               # pending queries (sum of request sizes)
    hiwater: int = 0            # max fill ever seen

    def oldest_deadline(self) -> Optional[float]:
        return self.queue[0].deadline if self.queue else None


class QueryRouter:
    """Admission + fair drain across per-tenant bounded queues."""

    def __init__(self, *, queue_cap: int, deadline_s: float,
                 max_request: int):
        if queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.default_queue_cap = queue_cap
        self.default_deadline_s = deadline_s
        self.max_request = max_request     # session max_batch: slab bound
        self.tenants: Dict[str, TenantQueue] = {}
        self.rejections: Dict[str, Dict[str, int]] = {}
        self._rr: List[str] = []           # round-robin tenant order
        self._rr_next = 0

    # ------------------------------------------------------------ tenants
    def register(self, name: str, *, queue_cap: Optional[int] = None,
                 deadline_us: Optional[float] = None) -> TenantQueue:
        """Create (or fetch) a tenant queue; per-tenant overrides beat
        the router defaults. Tenants auto-register on first submit."""
        tq = self.tenants.get(name)
        if tq is not None:
            return tq
        tq = TenantQueue(
            name=name,
            queue_cap=(self.default_queue_cap if queue_cap is None
                       else int(queue_cap)),
            deadline_s=(self.default_deadline_s if deadline_us is None
                        else deadline_us * 1e-6))
        if tq.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        if tq.deadline_s <= 0:
            raise ValueError("deadline_us must be > 0")
        self.tenants[name] = tq
        self.rejections[name] = {r: 0 for r in REJECT_REASONS}
        self._rr.append(name)
        return tq

    # ---------------------------------------------------------- admission
    def admit(self, req: Request) -> None:
        """Enqueue ``req`` or raise :class:`Rejected` (counted)."""
        tq = self.register(req.tenant)
        n = req.pending.size
        limit = min(tq.queue_cap, self.max_request)
        if n > limit:
            self.rejections[req.tenant]["too_large"] += 1
            raise Rejected("too_large", req.tenant,
                           f"{n} queries > bound {limit}")
        if tq.fill + n > tq.queue_cap:
            self.rejections[req.tenant]["queue_full"] += 1
            raise Rejected("queue_full", req.tenant,
                           f"{tq.fill}+{n} > cap {tq.queue_cap}")
        tq.queue.append(req)
        tq.fill += n
        tq.hiwater = max(tq.hiwater, tq.fill)

    # -------------------------------------------------------------- drain
    @property
    def pending_queries(self) -> int:
        return sum(tq.fill for tq in self.tenants.values())

    def oldest_deadline(self) -> Optional[float]:
        heads = [d for tq in self.tenants.values()
                 if (d := tq.oldest_deadline()) is not None]
        return min(heads) if heads else None

    def take_batch(self, target: int) -> List[Request]:
        """Pop whole requests round-robin across tenants until ``target``
        queries are gathered or every queue is empty. The rotation cursor
        persists across calls, so drain order is fair over time even when
        every batch fills from a subset of tenants."""
        out: List[Request] = []
        got = 0
        n_t = len(self._rr)
        if n_t == 0:
            return out
        idle_rounds = 0
        while got < target and idle_rounds < n_t:
            name = self._rr[self._rr_next % n_t]
            self._rr_next = (self._rr_next + 1) % n_t
            tq = self.tenants[name]
            took = False
            # an oversize head still dispatches alone (got == 0): targets
            # below the max request size must not livelock — admission
            # already bounds every request at the session's slab capacity
            if tq.queue and (got == 0
                             or got + tq.queue[0].pending.size <= target):
                req = tq.queue.popleft()
                tq.fill -= req.pending.size
                out.append(req)
                got += req.pending.size
                took = True
            idle_rounds = 0 if took else idle_rounds + 1
        return out

    def stats(self) -> dict:
        return {name: {"pending": tq.fill, "hiwater": tq.hiwater,
                       "rejections": dict(self.rejections[name])}
                for name, tq in self.tenants.items()}
