"""reach.frontend — deadline-aware async serving front-end (DESIGN.md §7).

The layer between callers and a :class:`~repro_torch.reach.QuerySession`:

    from repro_torch.reach.frontend import Frontend, Rejected

    fe = Frontend(sess)                       # knobs from sess.spec
    t = fe.submit("tenant-a", srcs, dsts)     # bounded queues, admission
    fe.poll()                                 # deadline-aware coalescing
    answers = fe.results().get(t)

Pieces: :class:`QueryRouter` (per-tenant bounded queues + backpressure),
:class:`Frontend` (deadline coalescing loop with double-buffered slabs:
on a card each slab's ids are copied from a reused pinned host buffer
while the previous slab classifies),
:class:`AnswerCache` (epoch-keyed ``(version, u, v)`` LRU memoization),
:class:`FrontendStats` (per-tenant p50/p99, deadline misses, queue
high-water, cache hit rate, batch-occupancy histogram).
"""
from .cache import AnswerCache                                # noqa: F401
from .loop import Frontend                                    # noqa: F401
from .router import (QueryRouter, Rejected, Request,          # noqa: F401
                     TenantQueue)
from .stats import FrontendStats, LatencyTrack, TenantSnapshot  # noqa: F401

__all__ = [
    "Frontend", "QueryRouter", "Rejected", "Request", "TenantQueue",
    "AnswerCache", "FrontendStats", "LatencyTrack", "TenantSnapshot",
]
