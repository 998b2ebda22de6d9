"""Metrics registry: labeled counters, gauges and fixed-bucket histograms
with a JSON snapshot API and Prometheus text exposition (DESIGN.md §8.2).

Design constraints, in order:

  * **Zero hot-path churn.** The serving stats that already exist
    (``ServeStats``, ``SessionStats``, ``QueryStats``, ``BuildStats``,
    ``FrontendStats``) stay plain attribute accumulators — ``+=`` on a
    dataclass field, exactly as before. They join the registry as
    *collectors* (``register_stats``): a snapshot walks the live objects
    and emits their numeric fields as samples, so the registry is the one
    exposition surface without a function call per query.
  * **Merge-able.** Histograms use fixed bucket boundaries so snapshots
    from different processes/shards merge bucket-wise (``Histogram.merge``)
    — the multi-host serving tier aggregates leaves without resampling.
  * **Weak registration.** Collectors are held by weakref: a benchmark
    that builds forty sessions doesn't leak forty stats objects into
    every later snapshot; dead collectors drop out silently.

Sample naming follows Prometheus conventions: ``<prefix>_<field>`` with
labels, e.g. ``reach_engine_phase2_sparse{instance="a3f2"} 512``.
"""
from __future__ import annotations

import itertools
import math
import threading
import weakref
from bisect import bisect_left
from dataclasses import fields, is_dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_DEFAULT_BUCKETS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1,
    1.0, 2.5, 5.0, 10.0)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


class _Labeled:
    """Shared child-management for Counter/Gauge/Histogram."""

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], "_Labeled"] = {}
        self._lock = threading.Lock()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(f"metric {self.name!r} takes labels "
                             f"{self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):
        raise NotImplementedError

    def _iter_children(self):
        """(labels-dict, child) pairs; (self, {}) when unlabeled."""
        if not self.labelnames:
            yield {}, self
            return
        for key, child in list(self._children.items()):
            yield dict(zip(self.labelnames, key)), child


class Counter(_Labeled):
    """Monotone counter. ``inc()`` only goes up; ``reset()`` exists for
    workload-scoped accounting (mirrors the stats dataclasses)."""

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _new_child(self) -> "Counter":
        return Counter(self.name)

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount

    def reset(self) -> None:
        self.value = 0.0
        for _, c in self._iter_children():
            if c is not self:
                c.value = 0.0

    def samples(self):
        for lbl, c in self._iter_children():
            yield (self.name, lbl, c.value)

    prom_type = "counter"


class Gauge(_Labeled):
    """Point-in-time value (queue fill, overlay edges, EWMA...)."""

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _new_child(self) -> "Gauge":
        return Gauge(self.name)

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def samples(self):
        for lbl, c in self._iter_children():
            yield (self.name, lbl, c.value)

    prom_type = "gauge"


class Histogram(_Labeled):
    """Fixed-boundary bucket histogram (cumulative on exposition).

    ``buckets`` are the inclusive upper bounds of each bucket, strictly
    increasing; an implicit ``+Inf`` bucket tops them. Because boundaries
    are fixed at construction, two histograms with the same boundaries
    merge exactly (bucket-wise sum) — snapshots from sharded serving
    hosts aggregate without resampling, which a quantile sketch cannot
    guarantee.
    """

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = _DEFAULT_BUCKETS,
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("buckets must be non-empty and strictly "
                             f"increasing, got {b}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)       # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def _new_child(self) -> "Histogram":
        return Histogram(self.name, buckets=self.buckets)

    def observe(self, v: float) -> None:
        # bisect_left: v == boundary lands IN that bucket (le is inclusive)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def merge(self, other: "Histogram") -> None:
        """Bucket-wise accumulate ``other`` into self (same boundaries)."""
        if other.buckets != self.buckets:
            raise ValueError(
                f"histogram merge needs identical boundaries: "
                f"{self.buckets} vs {other.buckets}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def as_dict(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    def samples(self):
        for lbl, h in self._iter_children():
            cum = 0
            for le, c in zip(h.buckets, h.counts):
                cum += c
                yield (self.name + "_bucket", {**lbl, "le": _fmt_value(le)},
                       cum)
            yield (self.name + "_bucket", {**lbl, "le": "+Inf"}, h.count)
            yield (self.name + "_sum", lbl, h.sum)
            yield (self.name + "_count", lbl, h.count)

    prom_type = "histogram"


# --------------------------------------------------------------- registry --

def _stats_samples(prefix: str, obj, labels: Dict[str, str]):
    """Numeric fields of a stats dataclass (or plain dict) as samples.

    Dict-valued fields (e.g. ``SessionStats.buckets``) flatten into a
    ``key`` label; non-numeric leaves are skipped — the JSON snapshot is
    the lossless surface, exposition carries what Prometheus can."""
    if is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name)) for f in fields(obj))
    elif isinstance(obj, dict):
        items = obj.items()
    else:                                   # namespace-ish fallback
        items = ((k, v) for k, v in vars(obj).items()
                 if not k.startswith("_"))
    for name, v in items:
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float)):
            yield (f"{prefix}_{name}", labels, v)
        elif isinstance(v, dict):
            for k, kv in v.items():
                if isinstance(kv, bool):
                    kv = int(kv)
                if isinstance(kv, (int, float)):
                    yield (f"{prefix}_{name}", {**labels, "key": str(k)}, kv)


class _StatsCollector:
    """Weakly-held view of one live stats object (or provider callable)."""

    _ids = itertools.count()

    def __init__(self, prefix: str, owner, provider: Optional[Callable],
                 labels: Dict[str, str], prom_type: str):
        self.prefix = prefix
        self.ref = weakref.ref(owner)
        self.provider = provider            # None -> the owner IS the stats
        self.labels = dict(labels)
        self.labels.setdefault("instance", f"{next(self._ids):x}")
        self.prom_type = prom_type

    def collect(self):
        owner = self.ref()
        if owner is None:
            return None
        obj = self.provider(owner) if self.provider is not None else owner
        return list(_stats_samples(self.prefix, obj, self.labels))


class MetricsRegistry:
    """Process-wide metric namespace: first-class metrics + stat views."""

    def __init__(self):
        self._metrics: Dict[str, _Labeled] = {}
        self._collectors: List[_StatsCollector] = []
        self._lock = threading.Lock()

    # -------------------------------------------------- first-class metrics
    def _get_or_make(self, cls, name: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_make(Counter, name, help=help,
                                 labelnames=labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help=help,
                                 labelnames=labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = _DEFAULT_BUCKETS,
                  labelnames: Tuple[str, ...] = ()) -> Histogram:
        return self._get_or_make(Histogram, name, help=help, buckets=buckets,
                                 labelnames=labelnames)

    # ------------------------------------------------------------ stat views
    def register_stats(self, prefix: str, owner, *,
                       provider: Optional[Callable] = None,
                       labels: Optional[Dict[str, str]] = None,
                       prom_type: str = "counter") -> None:
        """Expose a live stats object through every future snapshot.

        ``owner`` is weakly held; when it dies the view disappears.
        ``provider(owner)`` (optional) computes the stats value at
        snapshot time — e.g. ``QuerySession`` registers itself with
        ``provider=lambda s: s.stats`` so the padded-query subtraction
        stays in one place. Numeric dataclass/dict fields become
        ``<prefix>_<field>`` samples."""
        col = _StatsCollector(prefix, owner, provider, labels or {},
                              prom_type)
        with self._lock:
            self._collectors.append(col)

    # ------------------------------------------------------------- snapshot
    def _collect_all(self):
        dead = []
        out = []
        for col in list(self._collectors):
            try:
                s = col.collect()
            except Exception:               # a dying owner must not poison
                s = None                    # the whole snapshot
            if s is None:
                dead.append(col)
            else:
                out.append((col, s))
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]
        return out

    def snapshot(self) -> dict:
        """JSON-ready view of every metric and registered stats object."""
        out: dict = {"metrics": {}, "stats": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out["metrics"][name] = {
                    "type": m.prom_type,
                    "series": [{"labels": lbl, **h.as_dict()}
                               for lbl, h in m._iter_children()]}
            else:
                out["metrics"][name] = {
                    "type": m.prom_type,
                    "series": [{"labels": lbl, "value": c.value}
                               for lbl, c in m._iter_children()]}
        for col, samples in self._collect_all():
            for name, lbl, v in samples:
                out["stats"].setdefault(name, []).append(
                    {"labels": lbl, "value": v})
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the registry."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.prom_type}")
            for sname, lbl, v in m.samples():
                lines.append(f"{sname}{_fmt_labels(lbl)} {_fmt_value(v)}")
        seen_types: Dict[str, str] = {}
        collected = []
        for col, samples in self._collect_all():
            for name, lbl, v in samples:
                seen_types.setdefault(name, col.prom_type)
                collected.append((name, lbl, v))
        collected.sort(key=lambda s: (s[0], sorted(s[1].items())))
        last = None
        for name, lbl, v in collected:
            if name != last:
                lines.append(f"# TYPE {name} {seen_types[name]}")
                last = name
            lines.append(f"{name}{_fmt_labels(lbl)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    # --------------------------------------------------------------- hygiene
    def clear(self) -> None:
        """Drop every metric and collector (tests)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def register_stats(prefix: str, owner, **kw) -> None:
    """Module-level convenience for ``get_registry().register_stats``."""
    _REGISTRY.register_stats(prefix, owner, **kw)


def metrics_snapshot() -> dict:
    return _REGISTRY.snapshot()


def prometheus_text() -> str:
    return _REGISTRY.prometheus_text()
