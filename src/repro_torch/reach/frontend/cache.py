"""Epoch-keyed answer cache — the memoization tier of the serving frontend.

The interval labels make cache keys trivial: an answer to ``u -> v`` is a
pure function of the graph *version*, so the logical key is
``(version, u, v) -> bool``. The version token is ``(epoch,
overlay_version)``: ``compact()`` bumps the epoch and ``apply_updates``
bumps the overlay version, so ANY graph mutation — fold or live insert —
invalidates the cache wholesale (DESIGN.md §7). Rather than storing the
version inside every key (dead entries would occupy LRU slots until
evicted one by one), the cache pins ONE current version and clears itself
when it changes; lookups and inserts carry the version they were computed
under, so an answer computed against an older graph can never be served
or stored against a newer one.

Hot pairs short-circuit the device entirely: a fully-cached request never
enters a tenant queue (see ``frontend.loop.Frontend.submit``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import numpy as np


class AnswerCache:
    """LRU ``(u, v) -> bool`` map pinned to one graph version.

    Keys are original node ids packed as ``u * n + v`` (n = node count of
    the served graph). Counters: ``hits`` / ``misses`` (per query pair),
    ``evictions`` (LRU), ``invalidations`` (wholesale clears on a version
    bump). ``capacity`` is the entry bound; 0 is rejected — callers gate
    construction on ``spec.cache_entries > 0`` instead.
    """

    def __init__(self, capacity: int, n_nodes: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        self.capacity = int(capacity)
        self.n = int(n_nodes)
        self.version = None
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    # ------------------------------------------------------------- helpers
    def __len__(self) -> int:
        return len(self._d)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return 0.0 if total == 0 else self.hits / total

    def _sync(self, version) -> None:
        if version != self.version:
            if self._d:
                self.invalidations += 1
                self._d.clear()
            self.version = version

    # ----------------------------------------------------------------- API
    def lookup(self, version, srcs: np.ndarray, dsts: np.ndarray, *,
               commit: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Probe a batch under ``version``. Returns ``(answers, hit)``
        bool arrays; ``answers[i]`` is meaningful only where ``hit[i]``.
        A version bump clears the cache before probing (every probe then
        misses — the post-bump answers repopulate it).

        ``commit=False`` peeks: the hit/miss counters and LRU recency are
        left untouched (the version sync still runs — invalidation is
        correctness, not accounting). The frontend peeks at ``submit()``
        and calls :meth:`commit_probe` only once admission succeeds, so a
        rejected request never skews hit_rate or recency."""
        self._sync(version)
        q = srcs.size
        ans = np.zeros(q, dtype=bool)
        hit = np.zeros(q, dtype=bool)
        d = self._d
        n = self.n
        for i in range(q):
            key = int(srcs[i]) * n + int(dsts[i])
            got = d.get(key)
            if got is None:
                continue
            if commit:
                d.move_to_end(key)
            ans[i] = got
            hit[i] = True
        if commit:
            self.hits += int(hit.sum())
            self.misses += q - int(hit.sum())
        return ans, hit

    def commit_probe(self, srcs: np.ndarray, dsts: np.ndarray,
                     hit: np.ndarray) -> None:
        """Account a prior ``lookup(commit=False)`` peek: bump the
        hit/miss counters and refresh LRU recency of the hit keys. Call
        once the probed request is actually being served (admitted or
        short-circuited); keys evicted since the peek just lose their
        recency touch."""
        d = self._d
        n = self.n
        for i in np.flatnonzero(hit):
            key = int(srcs[i]) * n + int(dsts[i])
            if key in d:
                d.move_to_end(key)
        n_hit = int(hit.sum())
        self.hits += n_hit
        self.misses += hit.size - n_hit

    def insert(self, version, srcs: np.ndarray, dsts: np.ndarray,
               answers: np.ndarray) -> None:
        """Store computed answers — but ONLY when ``version`` is still
        current: an in-flight batch that raced an ``apply_updates`` or
        ``compact`` must not poison the post-bump cache with pre-bump
        answers (tests/test_frontend_churn.py)."""
        if version != self.version:
            return
        d = self._d
        n = self.n
        for i in range(srcs.size):
            d[int(srcs[i]) * n + int(dsts[i])] = bool(answers[i])
            d.move_to_end(int(srcs[i]) * n + int(dsts[i]))
        while len(d) > self.capacity:
            d.popitem(last=False)
            self.evictions += 1

    def as_dict(self) -> dict:
        return {"entries": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate, "evictions": self.evictions,
                "invalidations": self.invalidations}
