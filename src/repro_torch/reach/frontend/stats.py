"""Frontend metrics: per-tenant latency percentiles, deadline misses,
queue high-water marks, cache hit rate, batch-occupancy histogram.

``FrontendStats`` is a plain snapshot (``as_dict`` → JSON for
BENCH_serve.json); the live accumulators live on the ``Frontend`` /
``QueryRouter`` / ``AnswerCache`` objects themselves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class LatencyTrack:
    """Submit→complete latencies for one tenant, with a bounded reservoir.

    Keeps every sample up to ``cap``; past that, reservoir-samples
    (deterministic LCG — no global RNG state) so percentiles stay
    unbiased while memory stays bounded under long-running serving.
    ``cap`` comes from ``IndexSpec.latency_window`` when the frontend
    builds these. An EMPTY track reports ``None`` percentiles/mean —
    never 0.0, which would drag aggregate latency reports toward zero
    for tenants that have not completed a request yet."""

    def __init__(self, cap: int = 1 << 16):
        if cap < 1:
            raise ValueError(f"latency window cap must be >= 1, got {cap}")
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._samples: List[float] = []
        self._lcg = 0x9E3779B9

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if len(self._samples) < self.cap:
            self._samples.append(seconds)
            return
        # reservoir: replace a random slot with probability cap/count
        self._lcg = (self._lcg * 1103515245 + 12345) & 0x7FFFFFFF
        j = self._lcg % self.count
        if j < self.cap:
            self._samples[j] = seconds

    def percentile(self, p: float) -> Optional[float]:
        """p-th percentile of the retained window, or None when empty.

        The reservoir keeps samples in *replacement* order, not arrival
        order — a wrapped window is an unordered bag, so the percentile
        sorts every call rather than assuming ring order."""
        if not self._samples:
            return None
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        return float(np.percentile(np.asarray(self._samples), p))

    @property
    def window(self) -> int:
        """Samples currently retained (== count until the cap is hit)."""
        return len(self._samples)

    @property
    def mean(self) -> Optional[float]:
        """Exact mean over ALL samples ever added (not just the window);
        None when no sample was added."""
        return None if self.count == 0 else self.total / self.count


@dataclass
class TenantSnapshot:
    """Per-tenant serving metrics at one point in time."""
    requests: int = 0            # admitted requests
    queries: int = 0             # query pairs admitted (incl. cache hits)
    completed: int = 0           # requests answered
    rejected: Dict[str, int] = field(default_factory=dict)
    deadline_misses: int = 0     # completed after their deadline
    cache_short_circuits: int = 0   # requests fully answered by the cache
    queue_hiwater: int = 0       # max pending queries ever enqueued
    # submit→complete latency percentiles; None until the tenant has
    # completed at least one request (an empty window has no percentile)
    p50_us: Optional[float] = None
    p99_us: Optional[float] = None
    mean_us: Optional[float] = None

    def as_dict(self) -> dict:
        return {"requests": self.requests, "queries": self.queries,
                "completed": self.completed, "rejected": dict(self.rejected),
                "deadline_misses": self.deadline_misses,
                "cache_short_circuits": self.cache_short_circuits,
                "queue_hiwater": self.queue_hiwater,
                "p50_us": self.p50_us, "p99_us": self.p99_us,
                "mean_us": self.mean_us}


@dataclass
class FrontendStats:
    """Snapshot of the whole serving frontend (``Frontend.stats``)."""
    tenants: Dict[str, TenantSnapshot] = field(default_factory=dict)
    n_batches: int = 0           # device slabs dispatched
    batch_queries: int = 0       # real queries across those slabs
    batch_slots: int = 0         # padded bucket slots across those slabs
    occupancy_hist: Dict[int, int] = field(default_factory=dict)
    # ^ real-query count per slab, bucketed by powers of two
    deadline_flushes: int = 0    # slabs cut by a deadline timer
    full_flushes: int = 0        # slabs cut by a full bucket
    forced_flushes: int = 0      # slabs cut by drain()
    cache: Optional[dict] = None

    @property
    def occupancy(self) -> float:
        """Mean real-queries / padded-slots per device slab — the batching
        win the deadline loop exists to deliver (1.0 = every slab full)."""
        return (0.0 if self.batch_slots == 0
                else self.batch_queries / self.batch_slots)

    @property
    def deadline_misses(self) -> int:
        return sum(t.deadline_misses for t in self.tenants.values())

    def as_dict(self) -> dict:
        return {
            "tenants": {k: v.as_dict() for k, v in self.tenants.items()},
            "n_batches": self.n_batches,
            "batch_queries": self.batch_queries,
            "batch_slots": self.batch_slots,
            "occupancy": self.occupancy,
            "occupancy_hist": {str(k): v
                               for k, v in sorted(self.occupancy_hist.items())},
            "deadline_flushes": self.deadline_flushes,
            "full_flushes": self.full_flushes,
            "forced_flushes": self.forced_flushes,
            "deadline_misses": self.deadline_misses,
            "cache": self.cache,
        }
