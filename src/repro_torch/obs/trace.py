"""Trace spans: low-overhead recorder + Chrome trace-event export
(DESIGN.md §8.3).

Two recording APIs over one ring buffer:

  * ``span(name, **attrs)`` — context manager; nests through a
    contextvar stack, so ``with span("finish"): with span("phase2"): ...``
    records phase2 with finish as its parent. When the process has
    initialised CUDA, enabled context-manager spans also open a
    ``torch.cuda.nvtx`` range of the same name, so device profiles line
    up with these host spans; a CPU run never initialises CUDA for it.
    A span measures host time: around an asynchronous kernel launch it
    covers the launch, not the kernel.
  * ``begin_span(name, parent=..., track=..., **attrs)`` /
    ``end_span(token)`` — explicit pair for spans whose lifetime crosses
    call boundaries, i.e. the double-buffered serving path where slab
    N+1's staging span OVERLAPS slab N's classify span. Explicit spans
    take only the parent they are handed (default: none) — they never
    adopt the ambient context-manager stack, so slab N+1's staging can
    never parent into slab N's in-flight spans. They also skip jax
    annotations: TraceMe demands strict per-thread nesting, which
    interleaved slabs violate by design.

Tracing is DISABLED by default: ``span()`` then returns a shared no-op
context manager and ``begin_span`` returns ``None`` — one flag check on
the hot path (budget <1%, DESIGN.md §8.5). Enable with ``enable_tracing()`` (or
``serve.py --trace-out``), export with ``export_chrome_trace(path)`` and
load the file at https://ui.perfetto.dev.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_DEFAULT_CAPACITY = 1 << 16


class SpanToken:
    """Handle for an explicit begin/end span (and test introspection)."""

    __slots__ = ("id", "name", "t0", "parent", "track", "attrs")

    def __init__(self, id: int, name: str, t0: float,
                 parent: Optional[int], track: Optional[str], attrs: dict):
        self.id = id
        self.name = name
        self.t0 = t0
        self.parent = parent
        self.track = track
        self.attrs = attrs


class _NoopSpan:
    """Shared do-nothing context manager — the disabled-tracing path."""

    __slots__ = ()
    id = None
    dur = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _LiveSpan:
    """Context-manager span: records one complete event on exit."""

    __slots__ = ("_tr", "name", "attrs", "id", "t0", "dur", "_parent_tok",
                 "_anno")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tr = tracer
        self.name = name
        self.attrs = attrs
        self.id = next(tracer._ids)
        self.t0 = 0.0
        self.dur = 0.0
        self._parent_tok = None
        self._anno = None

    def __enter__(self):
        tr = self._tr
        stack = tr._stack.get()
        self._parent_tok = tr._stack.set(stack + (self.id,))
        anno = tr._annotation(self.name, self.attrs)
        if anno is not None:
            try:
                anno.__enter__()
                self._anno = anno
            except Exception:       # profiler backend unavailable mid-run
                self._anno = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.dur = t1 - self.t0
        if self._anno is not None:
            try:
                self._anno.__exit__(*exc)
            except Exception:
                pass
        tr = self._tr
        stack = tr._stack.get()
        parent = stack[-2] if len(stack) >= 2 else None
        tr._stack.reset(self._parent_tok)
        tr._record(self.name, self.t0, self.dur, self.id, parent,
                   None, self.attrs)
        return False


class Tracer:
    """Ring-buffered span recorder, one per process (``get_tracer()``)."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._stack = contextvars.ContextVar("obs_span_stack", default=())
        self._lock = threading.Lock()
        self.n_recorded = 0                   # incl. events the ring dropped
        self._t_origin = time.perf_counter()
        self._annotate = None                 # lazy torch.cuda probe

    # ------------------------------------------------------------ recording
    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NOOP
        return _LiveSpan(self, name, attrs)

    def begin(self, name: str, *, parent: Optional[int] = None,
              track: Optional[str] = None, **attrs) -> Optional[SpanToken]:
        """Open an explicit span. NEVER consults the ambient stack: the
        double-buffered path hands parents around by token instead."""
        if not self.enabled:
            return None
        return SpanToken(next(self._ids), name, time.perf_counter(),
                         parent, track, attrs)

    def end(self, token: Optional[SpanToken],
            **extra_attrs) -> Optional[float]:
        """Close an explicit span; returns its duration (None if tracing
        was off at begin — a begin/end pair straddling ``enable_tracing``
        records nothing rather than a garbage span)."""
        if token is None:
            return None
        dur = time.perf_counter() - token.t0
        attrs = {**token.attrs, **extra_attrs} if extra_attrs else token.attrs
        self._record(token.name, token.t0, dur, token.id, token.parent,
                     token.track, attrs)
        return dur

    def record(self, name: str, t0: float, dur: float, *,
               parent: Optional[int] = None, track: Optional[str] = None,
               **attrs) -> Optional[int]:
        """Record a span retroactively from timestamps the caller already
        holds (the frontend's queue-wait rides on its EWMA clock reads —
        no extra clock calls, no token to carry). ``t0`` must be in the
        ``time.perf_counter`` domain. Returns the span id."""
        if not self.enabled:
            return None
        sid = next(self._ids)
        self._record(name, t0, dur, sid, parent, track, attrs)
        return sid

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker event (deadline misses, drops...)."""
        if not self.enabled:
            return
        self._record(name, time.perf_counter(), 0.0, next(self._ids),
                     None, None, attrs)

    def _record(self, name, t0, dur, id, parent, track, attrs) -> None:
        with self._lock:
            self._events.append({
                "name": name, "ts": t0 - self._t_origin, "dur": dur,
                "id": id, "parent": parent, "track": track,
                "args": attrs})
            self.n_recorded += 1

    # ---------------------------------------------------------- NVTX ranges
    def _annotation(self, name: str, attrs: dict):
        """An NVTX range beside the span, only while this process uses a
        CUDA device: ``torch.cuda.is_initialized()`` never initialises
        CUDA, so a CPU run pays one flag check and opens nothing."""
        if self._annotate is None:
            try:
                import torch
                self._annotate = torch.cuda
            except Exception:
                self._annotate = False
        cuda = self._annotate
        if not cuda or not cuda.is_initialized():
            return None
        return cuda.nvtx.range(name)

    # ------------------------------------------------------------ introspect
    @property
    def n_dropped(self) -> int:
        return self.n_recorded - len(self._events)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def children_of(self, span_id: int) -> List[dict]:
        return [e for e in self.events() if e["parent"] == span_id]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.n_recorded = 0
            self._t_origin = time.perf_counter()

    # --------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).

        Complete ('X') events; timestamps in microseconds from the tracer
        origin. Tracks map to tids: the implicit context-manager spans
        share tid 0 (they nest properly); each named track (the
        double-buffered slabs use ``slab-even``/``slab-odd``) gets its
        own tid, so overlapping slab lifetimes render as parallel rows
        instead of bogus nesting.
        """
        pid = os.getpid()
        tracks: Dict[str, int] = {}
        out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": "repro.reach"}}]
        for e in self.events():
            track = e["track"]
            if track is None:
                tid = 0
            else:
                tid = tracks.setdefault(track, len(tracks) + 1)
            args = {k: v for k, v in e["args"].items()}
            args["span_id"] = e["id"]
            if e["parent"] is not None:
                args["parent_id"] = e["parent"]
            out.append({"name": e["name"], "ph": "X", "pid": pid,
                        "tid": tid, "ts": e["ts"] * 1e6,
                        "dur": e["dur"] * 1e6, "cat": track or "host",
                        "args": args})
        for track, tid in tracks.items():
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": track}})
        return {"traceEvents": out, "displayTimeUnit": "ns"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enable_tracing(enabled: bool = True, *,
                   capacity: Optional[int] = None) -> Tracer:
    if capacity is not None and capacity != _TRACER.capacity:
        _TRACER.capacity = capacity
        _TRACER._events = deque(_TRACER._events, maxlen=capacity)
    _TRACER.enabled = enabled
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **attrs):
    """Module-level ``get_tracer().span`` (the common call site)."""
    if not _TRACER.enabled:
        return _NOOP
    return _LiveSpan(_TRACER, name, attrs)


def begin_span(name: str, **kw) -> Optional[SpanToken]:
    return _TRACER.begin(name, **kw)


def end_span(token: Optional[SpanToken], **extra) -> Optional[float]:
    return _TRACER.end(token, **extra)


def export_chrome_trace(path: str) -> str:
    return _TRACER.export_chrome_trace(path)
