"""The port's async frontend (``repro_torch.reach.frontend``) against the
reference's on the CPU: one saved artifact loaded by both packages, the
same tenants, request stream and injected clock, and per ticket the same
answers, the same rejections, flush reasons, occupancy histogram, cache
hits and latencies; a churn case after ``tests/test_frontend_churn.py``
(inserts, compaction, the answer cache invalidated) against the
reference and the brute-force closure of the live graph. The router,
cache and stats modules are copies of the reference's; the staging pool
the engine runs on a card keeps its rules here in pageable memory."""
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from repro.core.query import brute_force_closure
from repro.graphs.csr import build_csr
from repro.graphs.generators import layered_dag, random_dag
from repro.reach import IndexSpec as RefSpec
from repro.reach import QuerySession as RefSession
from repro.reach import Rejected as RefRejected
from repro.reach import build as ref_build
from repro.reach import load_index as ref_load
from repro.reach import save_index as ref_save
from repro.reach.frontend import Frontend as RefFrontend
from repro_torch.core.query_torch import PinnedIds
from repro_torch.reach import (Frontend, IndexSpec, QuerySession, Rejected,
                               load_index)


class Clock:
    """Deterministic clock: every read advances it by ``dt`` seconds, so
    both packages' frontends see the same times if they read it alike."""

    def __init__(self, dt: float = 37e-6):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def _pair(path, spec, **fe_kw):
    """(port frontend, reference frontend) over the artifact at ``path``,
    unbound sessions (inserts are not logged), one clock each."""
    port = QuerySession(load_index(path).index,
                        IndexSpec.from_dict(spec.to_dict()), device="cpu")
    ref = RefSession(ref_load(path).index, spec)
    return (Frontend(port, clock=Clock(), **fe_kw),
            RefFrontend(ref, clock=Clock(), **fe_kw))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    g = layered_dag(400, 10, 2.0, seed=9)
    spec = RefSpec(k=1, variant="L", use_seeds=False, overlay_cap=64,
                   deadline_us=300, tenant_queue_cap=96, cache_entries=512,
                   max_batch=256, min_bucket=32, phase2_chunk=32,
                   frontier_cap=64)
    path = tmp_path_factory.mktemp("frontend_idx")
    ref_save(path, ref_build(g, spec), spec)
    return g, spec, path


def _drive(fe, exc, g, seed: int):
    """One fixed script of submits (repeats that hit the cache, requests
    too large for a queue, bursts that fill one), polls and drains; the
    log of what every call returned or raised."""
    rng = np.random.default_rng(seed)
    log = []
    seen = []
    for i in range(60):
        tenant = f"t{i % 4}" if i % 2 else "t0"
        n = int(rng.choice([1, 5, 17, 40, 60, 97]))
        if seen and rng.random() < 0.3:
            qs, qt = seen[int(rng.integers(0, len(seen)))]
        else:
            qs = rng.integers(0, g.n, n)
            qt = rng.integers(0, g.n, n)
            seen.append((qs, qt))
        try:
            log.append(("ticket", fe.submit(tenant, qs, qt)))
        except exc as e:
            log.append(("rejected", e.reason, e.tenant))
        if i % 5 == 4:
            log.append(("poll", fe.poll()))
        if i % 17 == 16:
            log.append(("poll", fe.poll(force=True)))
        log.append(("results", {t: a.tolist()
                                for t, a in fe.results().items()}))
    log.append(("drain", {t: a.tolist() for t, a in fe.drain().items()}))
    return log


def _stats(fe):
    st = asdict(fe.stats)
    slow = fe.slowlog.as_dict()
    for e in slow["worst_slabs"] + slow["recent_misses"]:
        # the engine's own phase clocks are wall time; the rest is the
        # injected clock's
        for k in ("phase1", "phase2"):
            e["breakdown_us"].pop(k, None)
    return st, slow


@pytest.mark.parametrize("phase2", ["dense", "sparse", "host"])
def test_frontend_matches_reference(artifact, phase2):
    g, spec, path = artifact
    spec = replace(spec, phase2_mode=phase2)
    fe, ref = _pair(path, spec, batch_target=128)
    log, want = _drive(fe, Rejected, g, 3), _drive(ref, RefRejected, g, 3)
    assert log == want
    kinds = {e[0] for e in log}
    assert {"ticket", "rejected"} <= kinds
    assert {e[1] for e in log if e[0] == "rejected"} == {"queue_full",
                                                         "too_large"}
    st, slow = _stats(fe)
    assert (st, slow) == _stats(ref)
    assert st["deadline_flushes"] and st["full_flushes"]
    assert st["cache"]["hits"]
    assert any(t["cache_short_circuits"] for t in st["tenants"].values())
    # the same phase mix and batching underneath
    s, r = fe.session.stats.as_dict(), ref.session.stats.as_dict()
    for d in (s, r):
        d.pop("seconds")
        d.pop("ns_per_query")
    assert s == r
    if phase2 != "dense":
        assert s[f"phase2_{phase2}"] > 0


@pytest.mark.parametrize("seed,n,compact_at,cache_entries", [
    (11, 60, 2, 16), (402, 100, 0, 256)])
def test_cache_exact_under_churn_matches_reference(seed, n, compact_at,
                                                   cache_entries, tmp_path):
    rng = np.random.default_rng(seed)
    g = random_dag(n, 1.3, seed=seed)
    spec = RefSpec(k=1, variant="L", use_seeds=False, phase2_mode="auto",
                   overlay_cap=128)
    ref_save(tmp_path, ref_build(g, spec), spec)
    fe, ref = _pair(tmp_path, spec, batch_target=64,
                    cache_entries=cache_entries)
    edges = [(int(a), int(b)) for a in range(n) for b in g.neighbors(a)]
    for step in range(4):
        tc = brute_force_closure(build_csr(
            n, [a for a, _ in edges], [b for _, b in edges]))
        qs = rng.integers(0, n, size=24).astype(np.int64)
        qt = rng.integers(0, n, size=24).astype(np.int64)
        for _ in range(2):          # round 2 replays round 1 from the cache
            got = fe.query("t", qs, qt)
            want = np.array([tc[s, d] for s, d in zip(qs, qt)])
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(ref.query("t", qs, qt), want)
        neg = np.flatnonzero(~want)
        us, vs = [], []
        if neg.size:                 # a cached NEG that must flip to POS
            us.append(qs[neg[0]])
            vs.append(qt[neg[0]])
        us.extend(rng.integers(0, n, size=2))
        vs.extend(rng.integers(0, n, size=2))
        us, vs = np.asarray(us, np.int64), np.asarray(vs, np.int64)
        keep = us != vs
        assert fe.apply_updates(us[keep], vs[keep]) == ref.apply_updates(
            us[keep], vs[keep])
        edges.extend(zip(us[keep].tolist(), vs[keep].tolist()))
        if step == compact_at:
            fe.compact()
            ref.compact()
    st, slow = _stats(fe)
    assert (st, slow) == _stats(ref)
    assert st["cache"]["invalidations"] >= 1
    assert fe.session.epoch == ref.session.epoch == 1
    assert fe.session.stats.n_updates == ref.session.stats.n_updates


def test_pinned_pool_never_hands_out_a_held_buffer():
    pool = PinnedIds(pin=False)
    m = PinnedIds.MIN_PAIRS
    a, b = pool.take(4 * m), pool.take(2 * m)
    c = pool.take(100)                  # two held: a third allocates
    assert pool.n_allocated == 3
    assert [t.numel() for t in (a, b, c)] == [8 * m, 4 * m, 2 * m]
    assert len({t.data_ptr() for t in (a, b, c)}) == 3
    pool.give(c)
    pool.give(a)
    pool.give(b)                        # the pool keeps the two largest
    assert [t.data_ptr() for t in pool.free] == [a.data_ptr(),
                                                 b.data_ptr()]
    d = pool.take(3 * m)                # the first free one that holds it
    assert d.data_ptr() == a.data_ptr() and pool.n_allocated == 3
    e = pool.take(5 * m)                # b holds 2 * m pairs: allocate
    assert pool.n_allocated == 4 and e.numel() == 10 * m
    assert d.dtype == torch.int64
