"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``) on the CPU: the same calls give the same registry export
(JSON snapshot and Prometheus text), the same slow-slab log and the same
trace events up to their timestamps; a ``QuerySession`` of either package
over one artifact records the same span names, attributes and nesting,
and its registry views equal its stats objects. Spans open no NVTX range
and never initialise CUDA on a CPU run."""
import gc
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.graphs.generators import random_dag
from repro.reach import IndexSpec as RefSpec
from repro.reach import QuerySession as RefSession
from repro.reach import build as ref_build
from repro.reach import save_index as ref_save
from repro.reach.frontend import Frontend as RefFrontend
from repro_torch import obs
from repro_torch.reach import Frontend, IndexSpec, QuerySession, load_index


@dataclass
class _Stats:
    n_queries: int = 0
    seconds: float = 0.0
    ok: bool = True
    buckets: dict = field(default_factory=dict)
    name: str = "x"                      # non-numeric: skipped by both


def _drive_registry(mod):
    """One fixed sequence of metric and collector calls on a fresh
    registry of ``mod`` (either package's ``obs.metrics``)."""
    reg = mod.MetricsRegistry()
    c = reg.counter("reqs_total", "requests", labelnames=("tenant",))
    c.labels(tenant="a").inc()
    c.labels(tenant="b").inc(2.5)
    g = reg.gauge("fill", "queue fill")
    g.set(7)
    g.dec(2)
    h = reg.histogram("lat_seconds", "latency", buckets=(1e-3, 1e-2, 0.1))
    for v in (5e-4, 1e-3, 0.05, 3.0):
        h.observe(v)
    hl = reg.histogram("svc_seconds", labelnames=("slab",))
    hl.labels(slab="0").observe(2e-6)
    owner = _Stats(n_queries=12, seconds=0.25, buckets={256: 3, 512: 1})
    reg.register_stats("reach_x", owner, labels={"instance": "i0"})
    reg.register_stats("reach_y", owner, provider=lambda o: {
        "a": o.n_queries * 2, "b": 1.5, "skip": "text"},
        labels={"instance": "i1"}, prom_type="gauge")
    dead = _Stats()
    reg.register_stats("reach_dead", dead, labels={"instance": "i2"})
    del dead
    gc.collect()
    return reg, owner


def test_registry_export_matches_reference():
    reg, owner = _drive_registry(obs.metrics)
    ref_reg, ref_owner = _drive_registry(ref_obs.metrics)
    assert reg.snapshot() == ref_reg.snapshot()
    assert reg.prometheus_text() == ref_reg.prometheus_text()
    snap = reg.snapshot()
    assert "reach_dead_n_queries" not in snap["stats"]
    assert snap["stats"]["reach_x_n_queries"] == [
        {"labels": {"instance": "i0"}, "value": 12}]


def _drive_slowlog(mod):
    log = mod.SlowLog(top_n=3, miss_ring=2)
    rng = np.random.default_rng(4)
    for i in range(12):
        log.observe_slab(slab=i, service_s=float(rng.random()) * 1e-3,
                         n_queries=int(rng.integers(1, 999)),
                         deadline_misses=int(i % 4 == 0),
                         breakdown={"stage": 1e-5 * i, "phase1": 2e-5})
    return log


def test_slowlog_matches_reference():
    log, ref_log = _drive_slowlog(obs), _drive_slowlog(ref_obs)
    assert log.as_dict() == ref_log.as_dict()
    assert log.format_report() == ref_log.format_report()
    assert log.as_dict()["n_misses"] == 3


def _drive_tracer(mod):
    tr = mod.trace.Tracer(capacity=64)
    tr.enabled = True
    with tr.span("outer", step=1):
        with tr.span("inner", q=3):
            tok = tr.begin("slab", track="slab-0", slab=0)
        tok2 = tr.begin("slab", track="slab-1", parent=tok.id, slab=1)
        tr.instant("deadline_miss", ticket=5)
    tr.end(tok, done=True)
    tr.end(tok2)
    tr.record("queue_wait", tr._t_origin, 1e-3, track="requests", ticket=1)
    return tr


def _strip(events, keys=("ts", "dur")):
    return [{k: v for k, v in e.items() if k not in keys} for e in events]


def test_trace_events_match_reference():
    tr, ref_tr = _drive_tracer(obs), _drive_tracer(ref_obs)
    assert _strip(tr.events()) == _strip(ref_tr.events())
    doc, ref_doc = tr.chrome_trace(), ref_tr.chrome_trace()
    assert _strip(doc["traceEvents"], ("ts", "dur", "pid")) == _strip(
        ref_doc["traceEvents"], ("ts", "dur", "pid"))
    assert doc["displayTimeUnit"] == ref_doc["displayTimeUnit"]
    assert [e["name"] for e in tr.events()] == [
        "inner", "deadline_miss", "outer", "slab", "slab", "queue_wait"]


def test_spans_open_no_nvtx_range_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tr = obs.trace.Tracer()
    tr.enabled = True
    with tr.span("phase1", q=4):
        pass
    assert tr._annotation("phase1", {}) is None
    assert not torch.cuda.is_initialized()
    assert [e["name"] for e in tr.events()] == ["phase1"]


# -------------------------------------------------- the serving stack
@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    g = random_dag(300, 1.6, seed=12)
    spec = RefSpec(k=1, variant="L", use_seeds=False, phase2_mode="sparse",
                   phase2_chunk=16, frontier_cap=16, frontier_cap_max=16,
                   overlay_cap=64, max_batch=256, min_bucket=32)
    path = tmp_path_factory.mktemp("obs_idx")
    ref_save(path, ref_build(g, spec), spec)
    return g, spec, path


def _sessions(artifact, phase2):
    """A session of each package over the one artifact, same spec."""
    from dataclasses import replace

    from repro.reach import load_index as ref_load
    g, spec, path = artifact
    spec = replace(spec, phase2_mode=phase2)
    art = load_index(path)
    port = QuerySession(art.index, IndexSpec.from_dict(spec.to_dict()),
                        packed=art.packed, device="cpu")
    return g, port, RefSession(ref_load(path).index, spec)


def _tree(events):
    """(name, parent's name, attributes) of every event, in order."""
    names = {e["id"]: e["name"] for e in events}
    return [(e["name"], names.get(e["parent"]), e["track"], e["args"])
            for e in events]


@pytest.fixture()
def tracing():
    for mod in (obs, ref_obs):
        mod.enable_tracing(True)
        mod.get_tracer().clear()
    yield
    for mod in (obs, ref_obs):
        mod.enable_tracing(False)
        mod.get_tracer().clear()


@pytest.mark.parametrize("phase2", ["sparse", "host", "dense"])
def test_session_spans_match_reference(artifact, phase2, tracing):
    g, port, ref = _sessions(artifact, phase2)
    rng = np.random.default_rng(9)
    qs = rng.integers(0, g.n, 300)
    qt = rng.integers(0, g.n, 300)
    for mod in (obs, ref_obs):
        mod.get_tracer().clear()
    got = port.query(qs, qt)
    h = port.begin(port.stage(qs[:40], qt[:40]))
    got_staged = port.finish(h)
    want = ref.query(qs, qt)
    want_staged = ref.finish(ref.begin(ref.stage(qs[:40], qt[:40])))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_staged, want_staged)
    ev, ref_ev = obs.get_tracer().events(), ref_obs.get_tracer().events()
    assert _tree(ev) == _tree(ref_ev)
    names = {e["name"] for e in ev}
    assert {"phase1", "phase2", "stage", "dispatch", "finish"} <= names
    if phase2 == "sparse":          # cap 16, max 16: the host at a retry
        assert {"phase2.overflow_retry", "phase2.host_fallback"} <= names
    finish = next(e for e in ev if e["name"] == "finish")
    assert any(e["name"] == "phase1" and e["parent"] == finish["id"]
               for e in ev)


def _exported(mod, prefix):
    """{sample name: [values]} of the registry's stat views under
    ``prefix`` (instance labels dropped: each package numbers its own)."""
    out = {}
    for name, samples in mod.metrics_snapshot()["stats"].items():
        if name.startswith(prefix):
            out[name] = sorted(
                (tuple(sorted((k, v) for k, v in s["labels"].items()
                              if k != "instance")), s["value"])
                for s in samples)
    return out


class _Clock:
    def __init__(self, dt=40e-6):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def test_registry_views_equal_stats_and_reference(artifact):
    for mod in (obs, ref_obs):
        mod.get_registry().clear()
    g, port, ref = _sessions(artifact, "sparse")   # both register here
    fes = [cls(sess, batch_target=128, clock=_Clock())
           for cls, sess in ((Frontend, port), (RefFrontend, ref))]
    rng = np.random.default_rng(2)
    for i in range(40):
        qs = rng.integers(0, g.n, int(rng.integers(1, 30)))
        qt = rng.integers(0, g.n, qs.size)
        for fe in fes:
            fe.submit(f"t{i % 3}", qs, qt)
            if i % 4 == 3:
                fe.poll()
    got, want = fes[0].drain(), fes[1].drain()
    assert got.keys() == want.keys()
    for t in got:
        np.testing.assert_array_equal(got[t], want[t])
    for prefix in ("reach_frontend", "reach_engine"):
        assert _exported(obs, prefix) == _exported(ref_obs, prefix)
    sess_got = _exported(obs, "reach_session")
    sess_want = _exported(ref_obs, "reach_session")
    sess_got.pop("reach_session_seconds")       # wall time
    sess_want.pop("reach_session_seconds")
    assert sess_got == sess_want
    # the views read the live objects: one sample each, equal to them
    snap = obs.metrics_snapshot()["stats"]
    flat = fes[0]._flat_stats()
    for key, v in flat.items():
        assert [s["value"] for s in snap[f"reach_frontend_{key}"]] == [v]
    for key in ("n_queries", "phase1_pos", "phase2_sparse", "n_batches"):
        vals = [s["value"] for s in snap[f"reach_session_{key}"]]
        assert vals == [getattr(port.stats, key)]
    assert [s["value"] for s in snap["reach_engine_n_queries"]] == [
        port.engine.stats.n_queries]
    # the frontend's histograms (fed by the injected clock) agree too
    m, ref_m = (mod.metrics_snapshot()["metrics"] for mod in (obs, ref_obs))
    assert m == ref_m and m["frontend_slab_service_seconds"]["series"]


def test_serve_entrypoint_matches_reference(tmp_path):
    """``launch/serve.py`` with ``--tenants``, ``--metrics-dump`` and
    ``--trace-out``: the same answers and phase mix as the reference's
    entry point, every request completed through the frontend, a metrics
    dump with phase-1 counters and the slow-slab log, and a trace-event
    file."""
    import json

    from repro.launch.serve import serve_reachability as ref_serve
    from repro_torch.launch.serve import serve_reachability
    kw = dict(n_tenants=2, request_size=16)
    try:
        got = serve_reachability(
            300, 1.5, 512, IndexSpec(max_batch=256, min_bucket=256),
            device="cpu", metrics_dump=str(tmp_path / "m.json"),
            trace_out=str(tmp_path / "t.json"), **kw)
        want = ref_serve(n_nodes=300, avg_deg=1.5, n_queries=512, batch=256,
                         **kw)
    finally:
        for mod in (obs, ref_obs):
            mod.enable_tracing(False)
            mod.get_tracer().clear()
    assert got["positive"] == want["positive"]
    s, r = got["stats"].as_dict(), want["stats"].as_dict()
    for d in (s, r):
        d.pop("seconds")
        d.pop("ns_per_query")
    assert s == r
    fs, fr = got["frontend_stats"], want["frontend_stats"]
    assert {k: (t.requests, t.queries, t.completed)
            for k, t in fs.tenants.items()} == {
        k: (t.requests, t.queries, t.completed)
        for k, t in fr.tenants.items()}
    assert fs.batch_queries == fr.batch_queries == 512
    snap = json.loads((tmp_path / "m.json").read_text())
    assert sum(x["value"] for x in snap["stats"]["reach_session_phase1_pos"]
               ) > 0
    assert snap["slowlog"]["worst_slabs"]
    doc = json.loads((tmp_path / "t.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"phase1", "coalesce", "finish", "slab"} <= names
