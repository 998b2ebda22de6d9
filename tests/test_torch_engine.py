"""The port's two-phase engine and QuerySession on the CPU against the
reference's, on identical state: an index built by the reference package,
written out in its artifact layout (``reach.persist``) and rebuilt by
``repro_torch.reach.index_from_arrays``. Answers and phase statistics are
integers and must be equal (the reference's sparse phase 2 runs its fused
Pallas kernels in interpret mode, whose overflow rule the port follows).
Workloads follow tests/test_query_engines.py and tests/test_frontier_sparse.py.
"""
from dataclasses import asdict, fields

import numpy as np
import pytest
import torch

from repro import reach as ref_reach
from repro.core.query import brute_force_closure
from repro.core.query_jax import DeviceQueryEngine as RefEngine
from repro.graphs import generators as ref_gen
from repro.reach.persist import _load_arrays, save_index
from repro_torch import reach
from repro_torch.core.query_torch import DeviceQueryEngine, ServeStats
from repro_torch.core.workload import positive_queries, random_queries


def _convert(tmp_path, graph, **spec_kw):
    """(graph, reference index, port (index, packed, ell)) on one state."""
    g = graph(ref_gen)
    spec = ref_reach.IndexSpec(**spec_kw)
    ix_ref = ref_reach.build(g, spec)
    save_index(tmp_path, ix_ref, spec)
    arrays, manifest = _load_arrays(tmp_path, None)
    return g, ix_ref, reach.index_from_arrays(arrays, manifest["extra"])


def _stats(st):
    """The reference stats restricted to the port's fields."""
    return {f.name: getattr(st, f.name) for f in fields(ServeStats)}


LAYERED = lambda m: m.layered_dag(500, 20, 3.0, seed=3)          # noqa: E731
WEAK = dict(k=1, variant="L", use_seeds=False)


@pytest.mark.parametrize("graph,spec_kw,eng_kw,n_q", [
    # auto → dense at n ≤ 8192 (tests/test_query_engines.py)
    (lambda m: m.scale_free_digraph(300, 3.0, seed=4), {}, {}, 1500),
    (LAYERED, WEAK, dict(phase2_mode="dense"), 1000),
    (LAYERED, WEAK, dict(phase2_mode="host"), 1500),
    (LAYERED, WEAK, dict(phase2_mode="sparse"), 1000),
    # tail sweep (tests/test_frontier_sparse.py)
    (lambda m: m.layered_dag(400, 16, 3.0, seed=4), WEAK,
     dict(phase2_mode="sparse", ell_width=1), 600),
    # chunk padding + overflow → 4x retry
    (LAYERED, WEAK, dict(phase2_mode="sparse", phase2_chunk=64,
                         frontier_cap=64, frontier_cap_max=1 << 14), 800),
    # cap exhaustion → host fallback
    (LAYERED, WEAK, dict(phase2_mode="sparse", phase2_chunk=64,
                         frontier_cap=64, frontier_cap_max=64), 800),
    # 64 seeds: the 12-array layout (kernel 2) in phase 1 and phase 2
    (LAYERED, dict(k=1, variant="L", n_seeds=64),
     dict(phase2_mode="sparse"), 1500),
])
def test_engine_matches_reference(tmp_path, graph, spec_kw, eng_kw, n_q):
    g, ix_ref, (ix, packed, ell) = _convert(tmp_path, graph, **spec_kw)
    qs, qt = random_queries(g, n_q, seed=1)
    ps, pt = positive_queries(g, n_q // 5, seed=2)
    qs, qt = np.concatenate([qs, ps]), np.concatenate([qt, pt])
    ref = RefEngine(ix_ref, kernel_impl="pallas", **eng_kw)
    eng = DeviceQueryEngine(ix, packed=packed, ell=ell, device="cpu",
                            **eng_kw)
    want = ref.answer(qs, qt)
    got = eng.answer(qs, qt)
    np.testing.assert_array_equal(got, want)
    assert asdict(eng.stats) == _stats(ref.stats)
    assert eng.phase2_mode == ref.phase2_mode
    assert eng.stats.phase2_queries > 0 or not spec_kw
    tc = brute_force_closure(g)
    np.testing.assert_array_equal(got, tc[qs, qt])
    assert got[-(n_q // 5):].all()             # the positive workload
    assert eng.last_phase1_s > 0.0


def test_sparse_retry_and_fallback_visible(tmp_path):
    _, _, (ix, packed, ell) = _convert(tmp_path, LAYERED, **WEAK)
    qs, qt = random_queries(LAYERED(ref_gen), 1500, seed=1)
    kw = dict(phase2_mode="sparse", phase2_chunk=64, frontier_cap=64,
              packed=packed, ell=ell, device="cpu")
    retry = DeviceQueryEngine(ix, frontier_cap_max=1 << 14, **kw)
    fallback = DeviceQueryEngine(ix, frontier_cap_max=64, **kw)
    np.testing.assert_array_equal(retry.answer(qs, qt),
                                  fallback.answer(qs, qt))
    assert retry.stats.sparse_retries > 0 and retry.stats.phase2_host == 0
    assert fallback.stats.phase2_host > 0
    assert retry.last_phase2_s > 0.0


def test_index_from_arrays_without_packed(tmp_path):
    g = ref_gen.random_dag(200, 2.0, seed=0)
    ix_ref = ref_reach.build(g)
    save_index(tmp_path, ix_ref, include_packed=False)
    arrays, manifest = _load_arrays(tmp_path, None)
    ix, packed, ell = reach.index_from_arrays(arrays, manifest["extra"])
    assert packed is None and ell is None
    qs, qt = random_queries(g, 500, seed=3)
    np.testing.assert_array_equal(
        DeviceQueryEngine(ix, device="cpu").answer(qs, qt),
        RefEngine(ix_ref).answer(qs, qt))


# ---------------------------------------------------------- the session
def _sessions(tmp_path, n=300, **kw):
    graph = lambda m: m.scale_free_digraph(n, 3.0, seed=0)    # noqa: E731
    spec_kw = dict(k=1, variant="L", use_seeds=False, **kw)
    g, ix_ref, (ix, packed, ell) = _convert(tmp_path, graph, **spec_kw)
    ref = ref_reach.QuerySession(ix_ref, ref_reach.IndexSpec(**spec_kw))
    sess = reach.QuerySession(ix, reach.IndexSpec(**spec_kw), packed=packed,
                              ell=ell, device="cpu")
    return g, ref, sess


def _session_stats(st):
    d = st.as_dict()
    d.pop("seconds"), d.pop("ns_per_query")
    return d


def test_session_matches_reference_across_buckets(tmp_path):
    g, ref, sess = _sessions(tmp_path, min_bucket=64, max_batch=256)
    qs, qt = random_queries(g, 1000, seed=2)     # 3 full + 1 padded batch
    got = sess.query(qs, qt)
    np.testing.assert_array_equal(got, ref.query(qs, qt))
    np.testing.assert_array_equal(got, brute_force_closure(g)[qs, qt])
    want = _session_stats(ref.stats)
    for k in ("n_updates", "n_overlay_hits", "n_compactions",
              "overlay_edges"):
        assert want.pop(k) == 0
    assert _session_stats(sess.stats) == want
    st = sess.stats
    assert st.n_batches == 4 and st.n_padded == 4 * 256 - 1000
    assert st.buckets == {256: 4}
    assert st.phase1_pos + st.phase1_neg + st.phase2_queries == 1000
    assert st.phase2_queries > 0


@pytest.mark.parametrize("mode", ["sparse", "host"])
def test_session_phase2_modes_match_reference(tmp_path, mode):
    g, ref, sess = _sessions(tmp_path, n=600, phase2_mode=mode,
                             kernel_impl="pallas", min_bucket=128,
                             max_batch=512)
    qs, qt = random_queries(g, 1300, seed=5)
    np.testing.assert_array_equal(sess.query(qs, qt), ref.query(qs, qt))
    assert _session_stats(sess.stats) == {
        k: v for k, v in _session_stats(ref.stats).items()
        if k in _session_stats(sess.stats)}


def test_session_submit_drain_and_staged(tmp_path):
    g, _, sess = _sessions(tmp_path, min_bucket=64, max_batch=256)
    qs, qt = random_queries(g, 500, seed=4)
    direct = sess.query(qs, qt)
    sess.reset_stats()
    t1 = sess.submit(qs[:100], qt[:100])
    t2 = sess.submit(qs[100:101], qt[100:101])
    t3 = sess.submit(qs[101:500], qt[101:500])
    assert sess.pending_queries == 500
    res = sess.drain()
    assert sess.pending_queries == 0
    np.testing.assert_array_equal(res[t1], direct[:100])
    np.testing.assert_array_equal(res[t2], direct[100:101])
    np.testing.assert_array_equal(res[t3], direct[101:500])
    assert sess.stats.n_batches == 2 and sess.drain() == {}
    # stage / begin / finish: batch N+1 staged while batch N is in flight
    sess.reset_stats()
    a = sess.begin(sess.stage(qs[:200], qt[:200]))
    b_staged = sess.stage(qs[200:450], qt[200:450])
    out_a = sess.finish(a)
    out_b = sess.finish(sess.begin(b_staged))
    np.testing.assert_array_equal(np.concatenate([out_a, out_b]),
                                  direct[:450])
    st = sess.stats
    assert st.n_queries == 450 and st.n_batches == 2
    assert st.buckets == {256: 2} and st.n_padded == 2 * 256 - 450
    with pytest.raises(ValueError):
        sess.stage(np.zeros(257, np.int64), np.zeros(257, np.int64))
    with pytest.raises(ValueError):
        sess.query(np.arange(3), np.arange(4))


def test_session_warmup_one_shape_per_bucket(tmp_path):
    g, _, sess = _sessions(tmp_path, min_bucket=64, max_batch=512)
    sess.warmup(512, 300, 100, 60)            # buckets 512, 128, 64
    assert sess.trace_count == 3
    rng = np.random.default_rng(9)
    for sz in (512, 300, 100, 777, 60, 513, 200):
        sess.query(rng.integers(0, g.n, sz), rng.integers(0, g.n, sz))
    assert sess.stats.n_queries == 512 + 300 + 100 + 777 + 60 + 513 + 200
    assert set(sess.stats.buckets) == {64, 128, 256, 512}
    assert sess.trace_count == 4              # + the 256 bucket of 200


# ------------------------------------------------------- spec and device
BAD_SPECS = [
    dict(k=0), dict(variant="X"), dict(variant="full"), dict(k=None),
    dict(c=0), dict(cover_method="nope"), dict(n_seeds=0),
    dict(phase2_mode="gpu"), dict(frontier_cap=1024, frontier_cap_max=512),
    dict(max_batch=128, min_bucket=256), dict(kernel_impl="cuda"),
    dict(mesh="2x4"), dict(placement="sharded", mesh="2y4"),
    dict(placement="replicated", mesh="2x4"),
    dict(placement="sharded", phase2_mode="dense"),
]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_spec_rejects_as_reference(bad):
    with pytest.raises(ValueError):
        ref_reach.IndexSpec(**bad)
    with pytest.raises(ValueError):
        reach.IndexSpec(**bad)


@pytest.mark.parametrize("spec_kw", [
    {}, dict(k=None, variant="full", use_seeds=False),
    dict(k=5, variant="L", c=2, cover_method="dp", n_seeds=64,
         phase2_mode="sparse", ell_width=16, use_pallas=False,
         kernel_impl="xla", max_batch=4096, min_bucket=64),
    dict(placement="sharded", mesh="2x4", phase2_mode="sparse"),
])
def test_spec_dict_roundtrips_reference_manifest(spec_kw):
    d = ref_reach.IndexSpec(**spec_kw).to_dict()
    assert reach.IndexSpec.from_dict(d).to_dict() == d
    with pytest.raises(ValueError):
        reach.IndexSpec.from_dict({**d, "warp_drive": True})


def test_unported_choices_raise():
    g = ref_gen.random_dag(100, 2.0, seed=0)
    with pytest.raises(NotImplementedError):
        reach.build(g, reach.IndexSpec(builder="wavefront",
                                       cover_method="topgap"))
    ix = reach.build(g)
    with pytest.raises(NotImplementedError):
        reach.make_engine(ix, reach.IndexSpec(placement="replicated"),
                          device="cpu")


def test_no_cuda_means_no_silent_cpu(monkeypatch):
    """Without a card, the default device raises; the CPU runs only when
    asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ix = reach.build(ref_gen.random_dag(100, 2.0, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryEngine(ix)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reach.QuerySession(ix)
    assert reach.QuerySession(ix, device="cpu").engine.device.type == "cpu"


@pytest.mark.parametrize("spec_kw", [dict(kernel_impl="xla"),
                                     dict(use_pallas=False)])
def test_card_refuses_plain_paths(monkeypatch, spec_kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ix = reach.build(ref_gen.random_dag(100, 2.0, seed=0))
    with pytest.raises(ValueError, match="CUDA kernels only"):
        reach.make_engine(ix, reach.IndexSpec(**spec_kw), device="cuda:0")
    # the CPU runs the plain versions whatever these two fields say
    reach.make_engine(ix, reach.IndexSpec(**spec_kw), device="cpu")
