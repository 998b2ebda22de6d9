"""Slow-slab / deadline-miss ring log (DESIGN.md §8.4).

The ``Frontend`` feeds every dispatched slab through ``observe_slab``
with its per-phase span breakdown (queue-wait / coalesce / stage /
phase1 / phase2 seconds). The log keeps:

  * the top-N worst slabs by service time (a min-heap, so a fast slab
    costs one comparison and no allocation), and
  * a bounded ring of the most recent deadline-miss events.

Unlike tracing this is ALWAYS on — the breakdown numbers ride on
timestamps the frontend already takes for its EWMA, so the marginal
cost is a heap peek per slab. ``launch/serve.py`` prints ``format_report()``
after a frontend run; ``as_dict()`` goes into ``--metrics-dump``.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional


class SlowLog:
    def __init__(self, top_n: int = 16, miss_ring: int = 64):
        if top_n <= 0:
            raise ValueError(f"top_n must be positive, got {top_n}")
        self.top_n = top_n
        self._heap: list = []          # (service_s, seq, entry) min-heap
        self._seq = itertools.count()
        self._misses: deque = deque(maxlen=miss_ring)
        self.n_slabs = 0
        self.n_misses = 0

    # ------------------------------------------------------------ ingest
    def observe_slab(self, *, slab: int, service_s: float, n_queries: int,
                     deadline_misses: int = 0,
                     breakdown: Optional[Dict[str, float]] = None) -> None:
        self.n_slabs += 1
        entry = {
            "slab": slab,
            "service_us": service_s * 1e6,
            "n_queries": n_queries,
            "deadline_misses": deadline_misses,
            "breakdown_us": {k: v * 1e6 for k, v in (breakdown or {}).items()},
        }
        item = (service_s, next(self._seq), entry)
        if len(self._heap) < self.top_n:
            heapq.heappush(self._heap, item)
        elif service_s > self._heap[0][0]:
            heapq.heapreplace(self._heap, item)
        if deadline_misses:
            self.n_misses += deadline_misses
            self._misses.append(entry)

    # ----------------------------------------------------------- reading
    def worst(self) -> List[dict]:
        """Top-N slabs, slowest first."""
        return [e for _, _, e in sorted(self._heap, reverse=True)]

    def recent_misses(self) -> List[dict]:
        return list(self._misses)

    def as_dict(self) -> dict:
        return {
            "n_slabs": self.n_slabs,
            "n_misses": self.n_misses,
            "worst_slabs": self.worst(),
            "recent_misses": self.recent_misses(),
        }

    def format_report(self, limit: int = 5) -> str:
        lines = [f"slowlog: {self.n_slabs} slabs, "
                 f"{self.n_misses} deadline misses"]
        for e in self.worst()[:limit]:
            bd = " ".join(f"{k}={v:.0f}us"
                          for k, v in e["breakdown_us"].items())
            lines.append(
                f"  slab={e['slab']} service={e['service_us']:.0f}us "
                f"q={e['n_queries']} misses={e['deadline_misses']}"
                + (f" [{bd}]" if bd else ""))
        return "\n".join(lines)

    def clear(self) -> None:
        self._heap.clear()
        self._misses.clear()
        self.n_slabs = 0
        self.n_misses = 0
