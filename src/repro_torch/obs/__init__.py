"""repro_torch.obs — the unified telemetry layer (DESIGN.md §8).

Three pillars, one process-wide surface:

  * **metrics** — a registry of labeled counters / gauges / fixed-bucket
    histograms with a JSON snapshot API (``snapshot()``) and Prometheus
    text exposition (``prometheus_text()``). The existing stats
    dataclasses (``SessionStats``, ``ServeStats``, ``QueryStats``,
    ``BuildStats``, ``FrontendStats``) keep their attribute API and are
    *registered as collectors*: every snapshot walks the live objects, so
    "where did this query go?" is one call away without adding a new
    counter field per PR.
  * **trace** — a low-overhead span recorder (``obs.span(...)`` context
    manager plus explicit ``begin_span``/``end_span`` for the
    double-buffered serving path) covering the full query lifecycle and
    the build pipeline's PLAN→WAVES→DRAIN stages, exportable as Chrome
    trace-event JSON (Perfetto-loadable). When tracing is enabled and
    the process uses a CUDA device, spans also open
    ``torch.cuda.nvtx`` ranges so device profiles line up with host
    spans. A span around an asynchronous launch measures host time: the
    launch, not the kernel. Disabled (the default), every span call is a
    shared no-op — the serving overhead is a single flag check.
  * **egress** — ``launch/serve.py --metrics-dump/--trace-out`` and the
    frontend's slow-slab / deadline-miss ring log (``obs.SlowLog``).

Typical use::

    from repro_torch import obs

    obs.enable_tracing()                      # or serve.py --trace-out
    with obs.span("phase2", mode="sparse"):
        ...
    obs.export_chrome_trace("trace.json")     # load in ui.perfetto.dev
    obs.metrics_snapshot()                    # dict, JSON-ready
    print(obs.prometheus_text())              # text/plain; version=0.0.4
"""
from .metrics import (Counter, Gauge, Histogram,          # noqa: F401
                      MetricsRegistry, get_registry, metrics_snapshot,
                      prometheus_text, register_stats)
from .slowlog import SlowLog                              # noqa: F401
from .trace import (begin_span, enable_tracing, end_span,  # noqa: F401
                    export_chrome_trace, get_tracer, span,
                    tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "metrics_snapshot", "prometheus_text",
    "register_stats",
    "span", "begin_span", "end_span", "enable_tracing", "tracing_enabled",
    "export_chrome_trace", "get_tracer",
    "SlowLog",
]
