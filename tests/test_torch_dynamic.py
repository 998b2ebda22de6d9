"""Live graph updates in the port (``repro_torch.reach.dynamic``) against
the reference's (``repro.reach.dynamic``) on the CPU, side by side on one
state: the reference builds and saves an index, the port rebuilds it from
the artifact's arrays (``reach.index_from_arrays``), and the same seeded
insert batches go to a reference ``QuerySession`` and a port one.

Answers, the phase mix and the overlay counters are integers and must be
equal, and the answers must equal brute force over the mutated graph. The
reference runs its fused Pallas loop in interpret mode
(``kernel_impl="pallas"``, whose overflow rule the port's fused layout
follows; the 12-array layout follows the XLA loop the reference falls back
to there). Compaction is held against the reference's ``compact_index``
(its wave merges on the XLA path: the Pallas merge-cover does not run on
this jax), label for label. Delta logs replay across the two packages.
Mirrors tests/test_dynamic_overlay.py and tests/test_dynamic_property.py.
"""
import shutil

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                                   # tier-1 bare env
    from _hyp import given, settings, st

import jax.numpy as jnp

from repro import reach as ref_reach
from repro.core.query import brute_force_closure
from repro.graphs import generators as ref_gen
from repro.graphs.csr import build_csr
from repro.kernels.frontier_fused import expand_frontier_overlay_fused
from repro.reach.dynamic import compact_index as ref_compact_index
from repro.reach.persist import _load_arrays
from repro.reach.persist import append_delta as ref_append_delta
from repro.reach.persist import load_deltas as ref_load_deltas
from repro.reach.persist import save_index as ref_save_index
from repro_torch import reach
from repro_torch.kernels import frontier_fused as ff
from repro_torch.reach.dynamic import OverlayFull, compact_index
from repro_torch.reach.persist import append_delta, load_deltas

SEED = 20260730
COUNTERS = ("n_queries", "n_positive", "phase1_pos", "phase1_neg",
            "phase2_queries", "phase2_dense", "phase2_sparse", "phase2_host",
            "sparse_retries", "n_updates", "n_overlay_hits", "n_compactions",
            "overlay_edges")


def _insert_batches(rng, n, n_batches, batch, back_p=0.0):
    """Seeded insert batches (original ids): edges lo -> hi keep a DAG
    built by ``random_dag`` acyclic; a share ``back_p`` runs hi -> lo."""
    out = []
    for _ in range(n_batches):
        us = rng.integers(0, n, size=batch)
        ud = rng.integers(0, n, size=batch)
        back = rng.random(batch) < back_p
        lo = np.where(back, np.maximum(us, ud), np.minimum(us, ud))
        hi = np.where(back, np.minimum(us, ud), np.maximum(us, ud))
        keep = lo != hi
        out.append((lo[keep], hi[keep]))
    return out


def _artifact(path, g, **kw):
    """The reference's index of ``g`` saved under ``path``; returns its
    spec pair (reference with the Pallas loop, port)."""
    ref_spec = ref_reach.IndexSpec(kernel_impl="pallas", **kw)
    ref_save_index(path, ref_reach.build(g, ref_spec), ref_spec)
    return ref_spec, reach.IndexSpec(**kw)


def _pair(path, g, **kw):
    """(reference session, port session on the CPU) on one index."""
    ref_spec, spec = _artifact(path, g, **kw)
    arrays, manifest = _load_arrays(path, None)
    ix, packed, ell = reach.index_from_arrays(arrays, manifest["extra"])
    ref = ref_reach.QuerySession(
        ref_reach.load_index(path).index, ref_spec)
    port = reach.QuerySession(ix, spec, packed=packed, ell=ell,
                              device="cpu")
    return ref, port


def _counters(sess):
    d = sess.stats.as_dict()
    return {k: d[k] for k in COUNTERS}


def _same(ref, port, qs, qt, closure=None):
    """Answers and counters equal (and equal to ``closure`` if given)."""
    want = ref.query(qs, qt)
    got = port.query(qs, qt)
    np.testing.assert_array_equal(got, want)
    if closure is not None:
        np.testing.assert_array_equal(got, closure[qs, qt])
    assert _counters(port) == _counters(ref)
    return got


def _same_overlay(ref, port):
    ro, po = ref.engine.overlay, port.engine.overlay
    assert (ro is None) == (po is None)
    if ro is not None:
        np.testing.assert_array_equal(po.can_reach_tail, ro.can_reach_tail)
        np.testing.assert_array_equal(po.is_tail, ro.is_tail)
        for a, b in zip(po.edges(), ro.edges()):
            np.testing.assert_array_equal(a, b)


def _same_labels(ix, ix_ref):
    assert len(ix.labels) == len(ix_ref.labels)
    for a, b in zip(ix.labels, ix_ref.labels):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for key in ("builder", "affected_nodes", "waves_touched", "waves_total",
                "total_intervals", "exact_intervals", "heap_recover_count",
                "hub_nodes", "merge_rounds", "host_fallbacks", "n_comp"):
        assert getattr(ix.stats, key) == getattr(ix_ref.stats, key), key
    np.testing.assert_array_equal(ix.cond.comp, ix_ref.cond.comp)


# ------------------------------------------------- answers under churn --

@pytest.mark.parametrize("mode,kw", [
    ("dense", {}), ("sparse", {}), ("host", {}),
    # 64 seeds: the 12-array layout (kernel 2's verdicts in the loop)
    ("sparse", dict(n_seeds=64)),
])
def test_overlay_matches_reference_under_churn(tmp_path, mode, kw):
    rng = np.random.default_rng(SEED)
    n = 300
    g = ref_gen.random_dag(n, 2.0, seed=1)
    ref, port = _pair(tmp_path, g, k=2, variant="G", phase2_mode=mode,
                      overlay_cap=256, min_bucket=64, max_batch=512, **kw)
    assert ("slab" in port.engine.dev) == ("n_seeds" not in kw)
    se, de = map(list, g.edges())
    for src, dst in _insert_batches(rng, n, 3, 15):
        assert port.apply_updates(src, dst) == ref.apply_updates(src, dst)
        _same_overlay(ref, port)
        se += list(src)
        de += list(dst)
        closure = brute_force_closure(build_csr(n, np.array(se),
                                                np.array(de)))
        qs = rng.integers(0, n, size=400)
        qt = rng.integers(0, n, size=400)
        _same(ref, port, qs, qt, closure)
    st = port.stats
    assert st.n_updates > 0 and st.overlay_edges == st.n_updates
    assert st.phase1_pos + st.phase1_neg + st.phase2_queries == st.n_queries


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_overlay_cycle_closing_inserts(tmp_path, mode):
    """Back edges make the union graph cyclic; answers stay exact, and
    ``compact`` takes the full rebuild as the reference does."""
    rng = np.random.default_rng(SEED + 1)
    n = 200
    g = ref_gen.random_dag(n, 1.5, seed=3)
    ref, port = _pair(tmp_path, g, k=2, variant="G", phase2_mode=mode,
                      overlay_cap=64, min_bucket=64, max_batch=512)
    se, de = map(list, g.edges())
    (src, dst), = _insert_batches(rng, n, 1, 20, back_p=0.5)
    src = np.concatenate([src, [de[0]]])      # reverse an existing edge
    dst = np.concatenate([dst, [se[0]]])
    port.apply_updates(src, dst)
    ref.apply_updates(src, dst)
    _same_overlay(ref, port)
    se += list(src)
    de += list(dst)
    closure = brute_force_closure(build_csr(n, np.array(se), np.array(de)))
    qs = rng.integers(0, n, size=500)
    qt = rng.integers(0, n, size=500)
    before = _same(ref, port, qs, qt, closure)
    assert port.compact().builder == ref.compact().builder == "full-rebuild"
    _same_labels(port.index, ref.index)
    np.testing.assert_array_equal(port.query(qs, qt), before)


def test_overlay_flips_base_negative(tmp_path):
    """An insert joining two unrelated chains flips a phase-1 NEG into a
    positive, counted as an overlay hit in both packages."""
    g = build_csr(6, [0, 1, 3, 4], [1, 2, 4, 5])
    ref, port = _pair(tmp_path, g, k=2, variant="G", phase2_mode="sparse",
                      n_seeds=4, overlay_cap=8)
    assert not _same(ref, port, np.array([2]), np.array([3]))[0]
    for sess in (ref, port):
        sess.apply_updates([2], [3])
    _same(ref, port, np.array([0, 5, 1]), np.array([5, 0, 4]))
    assert port.stats.n_overlay_hits >= 1


def test_one_sparse_state_across_add_batches(tmp_path):
    """The union tables are allocated once and rewritten in place: after
    the first overlay call, further add batches add no loop state."""
    rng = np.random.default_rng(SEED + 2)
    n = 400
    g = ref_gen.random_dag(n, 1.5, seed=2)
    _, port = _pair(tmp_path, g, k=1, variant="L", use_seeds=False,
                    phase2_mode="sparse", overlay_cap=256, min_bucket=64,
                    max_batch=512)
    eng = port.engine
    qs = rng.integers(0, n, size=512)
    qt = rng.integers(0, n, size=512)
    sizes, ptrs = [], []
    for src, dst in _insert_batches(rng, n, 6, 20):
        port.apply_updates(src, dst)
        port.query(qs, qt)
        sizes.append(len(eng._sparse_state))
        ptrs.append(tuple(t.data_ptr() for t in eng._overlay_dev()))
    assert eng.stats.phase2_sparse > 0
    assert sizes[-1] == sizes[0] and len(set(ptrs)) == 1


def test_overlay_kernel4_rule_matches_reference_loop(tmp_path):
    """Kernel 4's plain version with ``can_reach_tail``: the port's loop
    over the union tables equals the reference's post_verdict loop
    (``expand_frontier_overlay_fused``, interpret mode), pos and overflow,
    at a cap that overflows and one that does not."""
    rng = np.random.default_rng(SEED + 3)
    n = 300
    g = ref_gen.random_dag(n, 2.0, seed=5)
    ref, port = _pair(tmp_path, g, k=1, variant="L", use_seeds=False,
                      phase2_mode="sparse", overlay_cap=128)
    for src, dst in _insert_batches(rng, n, 2, 40):
        ref.apply_updates(src, dst)
        port.apply_updates(src, dst)
    ell, tsrc, tdst, hub, crt = port.engine._overlay_dev()
    r_ell, r_tsrc, r_tdst, r_hub, r_crt = ref.engine._overlay_dev()
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(r_tsrc))
    np.testing.assert_array_equal(hub.numpy(), np.asarray(r_hub))
    np.testing.assert_array_equal(crt.numpy(), np.asarray(r_crt))
    q = 64
    cs = rng.integers(0, n, size=q).astype(np.int32)
    ct = rng.integers(0, n, size=q).astype(np.int32)
    pad = np.zeros(q, bool)
    pad[-5:] = True
    dev = port.engine.dev
    overflowed = set()
    for cap in (q, 1024):
        want_pos, want_ovf = expand_frontier_overlay_fused(
            ref.engine.dev, r_ell, r_tsrc, r_tdst, r_hub, r_crt,
            jnp.asarray(cs), jnp.asarray(ct), jnp.asarray(pad),
            max_steps=n, cap=cap, interpret=True)
        pos, ovf = ff.expand_frontier_loop_fused(
            ell, tsrc, tdst, hub, torch.from_numpy(cs), torch.from_numpy(ct),
            torch.from_numpy(pad), n_nodes=n, max_steps=n, cap=cap,
            tables={"meta": dev["meta"], "slab": dev["slab"]},
            can_reach_tail=crt)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
        assert ovf == bool(want_ovf)
        overflowed.add(ovf)
    assert overflowed == {True, False}


# ----------------------------------------------------------- compaction --

@pytest.mark.parametrize("mode", ["auto", "incremental", "full"])
def test_compact_matches_reference(tmp_path, mode):
    rng = np.random.default_rng(SEED + 4)
    n = 400
    g = ref_gen.random_dag(n, 1.5, seed=7)
    ref, port = _pair(tmp_path / "a", g, k=2, variant="G",
                      phase2_mode="sparse", n_seeds=8, overlay_cap=128,
                      min_bucket=64, max_batch=1024)
    for src, dst in _insert_batches(rng, n, 2, 30):
        ref.apply_updates(src, dst)
        port.apply_updates(src, dst)
    qs = rng.integers(0, n, size=800)
    qt = rng.integers(0, n, size=800)
    before = _same(ref, port, qs, qt)
    cstats = port.compact(mode=mode)
    ref.compact(mode=mode)
    _same_labels(port.index, ref.index)
    assert cstats.builder == ("full-rebuild" if mode == "full"
                              else "compact")
    if mode != "full":
        assert 0 < cstats.waves_touched < cstats.waves_total
        assert cstats.affected_nodes < n
    assert port.stats.overlay_edges == 0 and port.stats.n_compactions == 1
    assert port.epoch == ref.epoch == 1
    np.testing.assert_array_equal(_same(ref, port, qs, qt), before)
    # a save/load round trip of the compacted index answers the same
    reach.save_index(tmp_path / "b", port.index, port.spec, epoch=port.epoch)
    loaded = reach.QuerySession.load(tmp_path / "b", device="cpu")
    assert loaded.epoch == 1
    np.testing.assert_array_equal(loaded.query(qs, qt), before)


def test_compact_index_direct_matches_reference(tmp_path):
    """``compact_index`` on its own, with the reference's index as input
    on both sides: the same new index. The graph, spec and inserts are
    ``test_compact_matches_reference``'s, so the reference's wave merges
    reuse their compiled shapes."""
    rng = np.random.default_rng(SEED + 4)
    n = 400
    g = ref_gen.random_dag(n, 1.5, seed=7)
    ref, port = _pair(tmp_path, g, k=2, variant="G", phase2_mode="sparse",
                      n_seeds=8, overlay_cap=128, min_bucket=64,
                      max_batch=1024)
    src, dst = map(np.concatenate, zip(*_insert_batches(rng, n, 2, 30)))
    got = compact_index(port.index, src, dst, port.spec,
                        mode="incremental", device="cpu")
    want = ref_compact_index(ref.index, src, dst, ref.spec,
                             mode="incremental")
    _same_labels(got, want)
    np.testing.assert_array_equal(got.seeds.s_plus, want.seeds.s_plus)
    np.testing.assert_array_equal(got.tl.tau, want.tl.tau)
    np.testing.assert_array_equal(got.tl.blevel, want.tl.blevel)


def test_compact_refused_with_a_handle_outstanding(tmp_path):
    g = ref_gen.random_dag(100, 1.5, seed=4)
    _, port = _pair(tmp_path, g, k=2, variant="G", phase2_mode="host",
                    overlay_cap=16)
    port.apply_updates([1, 2], [50, 60])
    handle = port.begin(port.stage(np.array([1, 2]), np.array([50, 3])))
    with pytest.raises(RuntimeError, match="outstanding"):
        port.compact()
    assert port.finish(handle)[0]
    port.compact()
    assert port.stats.n_compactions == 1


def test_auto_compact_off_raises_atomically(tmp_path):
    g = ref_gen.random_dag(100, 1.5, seed=4)
    _, port = _pair(tmp_path, g, k=2, variant="G", phase2_mode="host",
                    overlay_cap=4, auto_compact=False)
    with pytest.raises(OverlayFull):
        port.apply_updates(np.arange(0, 12), np.arange(30, 42))
    st = port.stats
    assert st.overlay_edges == 0 and st.n_updates == 0


# ----------------------------------------------- delta log and epochs --

def test_bad_node_ids_rejected_before_logging(tmp_path):
    g = ref_gen.random_dag(100, 1.5, seed=4)
    _artifact(tmp_path, g, k=2, variant="G", phase2_mode="host",
              overlay_cap=16)
    sess = reach.QuerySession.load(tmp_path, device="cpu")
    for bad in ([[5, 100], [10, 3]], [[-1], [5]], [[5], [200]]):
        with pytest.raises(ValueError, match="out of range"):
            sess.apply_updates(np.asarray(bad[0]), np.asarray(bad[1]))
    assert sess.stats.overlay_edges == 0
    assert load_deltas(tmp_path, sess.epoch) == []


def test_epoch_replay_matches_reference(tmp_path):
    """Bound sessions of both packages on copies of one artifact: inserts
    that force auto-compactions, then reloads that replay the log tail."""
    rng = np.random.default_rng(SEED + 30)
    n = 400
    g = ref_gen.scale_free_digraph(n, 2.0, seed=5, back_p=0.0)
    _artifact(tmp_path / "ref", g, k=2, variant="G", phase2_mode="sparse",
              overlay_cap=32)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref = ref_reach.QuerySession.load(tmp_path / "ref")
    port = reach.QuerySession.load(tmp_path / "port", device="cpu")
    for src, dst in _insert_batches(rng, n, 3, 20):
        assert port.apply_updates(src, dst) == ref.apply_updates(src, dst)
    assert port.stats.n_compactions == ref.stats.n_compactions >= 1
    assert port.epoch == ref.epoch == port.stats.n_compactions
    qs = rng.integers(0, n, size=800)
    qt = rng.integers(0, n, size=800)
    ans = _same(ref, port, qs, qt)
    _same_labels(port.index, ref.index)

    port2 = reach.QuerySession.load(tmp_path / "port", device="cpu")
    assert port2.epoch == port.epoch
    assert port2.stats.overlay_edges == port.stats.overlay_edges
    np.testing.assert_array_equal(port2.query(qs, qt), ans)
    port2.compact()
    assert port2.stats.overlay_edges == 0
    np.testing.assert_array_equal(port2.query(qs, qt), ans)
    port3 = reach.QuerySession.load(tmp_path / "port", device="cpu")
    assert port3.epoch == port2.epoch
    np.testing.assert_array_equal(port3.query(qs, qt), ans)


def test_bind_after_compact_does_not_overwrite_existing_log(tmp_path):
    """A session that compacted while unbound carries epoch 1 and a fresh
    log cursor; binding it to a directory that already holds epoch-1
    batches must re-list instead of overwriting them."""
    g = ref_gen.random_dag(200, 1.5, seed=7)
    _artifact(tmp_path, g, k=2, variant="G", phase2_mode="host",
              overlay_cap=4)
    sess = reach.QuerySession.load(tmp_path, device="cpu")
    sess.apply_updates([0, 1, 2, 3, 4], [9, 10, 11, 12, 13])  # compacts
    assert sess.epoch == 1
    sess.apply_updates([5], [14])          # logged under epoch 1
    n_before = len(load_deltas(tmp_path, 1))
    assert n_before >= 1

    art = reach.load_index(tmp_path, step=0)
    other = reach.QuerySession(art.index, art.spec, device="cpu")
    other.compact()                        # unbound: epoch 1, cursor 0
    other.bind_artifact(tmp_path, epoch=1)
    other.apply_updates([6], [15])
    assert len(load_deltas(tmp_path, 1)) == n_before + 1


def test_replay_with_smaller_cap_compacts_without_losing_edges(tmp_path):
    """Loading with a smaller overlay_cap than the log was written under
    compacts MID-replay; the unfolded tail is re-logged under the new
    epoch before its artifact commits, so every logged edge survives."""
    rng = np.random.default_rng(SEED + 40)
    n = 500
    g = ref_gen.scale_free_digraph(n, 2.0, seed=6, back_p=0.0)
    _artifact(tmp_path, g, k=2, variant="G", phase2_mode="sparse",
              overlay_cap=64)
    sess = reach.QuerySession.load(tmp_path, device="cpu")
    for src, dst in _insert_batches(rng, n, 3, 18):
        sess.apply_updates(src, dst)
    assert sess.stats.n_compactions == 0
    qs = rng.integers(0, n, size=2000)
    qt = rng.integers(0, n, size=2000)
    ans = sess.query(qs, qt)

    small = reach.IndexSpec(k=2, variant="G", phase2_mode="sparse",
                            overlay_cap=16)
    sess2 = reach.QuerySession.load(tmp_path, small, device="cpu")
    assert sess2.stats.n_compactions >= 1
    np.testing.assert_array_equal(sess2.query(qs, qt), ans)
    sess3 = reach.QuerySession.load(tmp_path, small, device="cpu")
    assert sess3.epoch == sess2.epoch
    np.testing.assert_array_equal(sess3.query(qs, qt), ans)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_delta_log_replays_across_packages(tmp_path, writer):
    """A log one package writes replays in the other: same file names and
    npz keys, the same overlay and answers after the load."""
    rng = np.random.default_rng(SEED + 50)
    n = 300
    g = ref_gen.random_dag(n, 2.0, seed=9)
    _artifact(tmp_path / "a", g, k=2, variant="G", phase2_mode="sparse",
              overlay_cap=256)
    if writer == "reference":
        sess = ref_reach.QuerySession.load(tmp_path / "a")
    else:
        sess = reach.QuerySession.load(tmp_path / "a", device="cpu")
    batches = _insert_batches(rng, n, 3, 20)
    for src, dst in batches:
        sess.apply_updates(src, dst)
    written = (ref_load_deltas if writer == "port" else load_deltas)(
        tmp_path / "a", 0)
    assert len(written) == 3
    for (s1, d1), (s2, d2) in zip(written, batches):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(d1, d2)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    ref = ref_reach.QuerySession.load(tmp_path / "a")
    port = reach.QuerySession.load(tmp_path / "b", device="cpu")
    assert port.stats.overlay_edges == ref.stats.overlay_edges > 0
    _same_overlay(ref, port)
    qs = rng.integers(0, n, size=600)
    qt = rng.integers(0, n, size=600)
    np.testing.assert_array_equal(_same(ref, port, qs, qt),
                                  sess.query(qs, qt))


def test_append_delta_names_match_reference(tmp_path):
    p1 = append_delta(tmp_path / "a", 3, [1, 2], [3, 4])
    p2 = ref_append_delta(tmp_path / "b", 3, [1, 2], [3, 4])
    assert p1.name == p2.name == "epoch_00000003_00000000.npz"
    p1 = append_delta(tmp_path / "a", 3, [5], [6])
    assert p1.name.endswith("_00000001.npz")
    got, want = load_deltas(tmp_path / "a", 3), ref_load_deltas(
        tmp_path / "a", 3)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# -------------------------------------------------------------- property --

@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000),
       n=st.integers(40, 160),
       avg_deg=st.floats(0.5, 2.5),
       batch=st.integers(1, 25),
       back_p=st.floats(0.0, 0.4),
       mode=st.sampled_from(["dense", "sparse"]),
       variant=st.sampled_from(["L", "G"]))
def test_overlay_equals_reference_at_every_step(tmp_path_factory, seed, n,
                                                avg_deg, batch, back_p,
                                                mode, variant):
    rng = np.random.default_rng(seed)
    g = ref_gen.random_dag(n, avg_deg, seed=seed + 1)
    ref, port = _pair(tmp_path_factory.mktemp("p"), g, k=2, variant=variant,
                      phase2_mode=mode, n_seeds=8, overlay_cap=128,
                      min_bucket=64, max_batch=512)
    se, de = map(list, g.edges())
    qs = rng.integers(0, n, size=300)
    qt = rng.integers(0, n, size=300)
    for src, dst in _insert_batches(rng, n, 3, batch, back_p):
        port.apply_updates(src, dst)
        ref.apply_updates(src, dst)
        _same_overlay(ref, port)
        se += list(src)
        de += list(dst)
        closure = brute_force_closure(build_csr(n, np.array(se),
                                                np.array(de)))
        _same(ref, port, qs, qt, closure)


@settings(max_examples=2, deadline=None)
@given(seed=st.integers(0, 10_000),
       n=st.integers(40, 120),
       back_p=st.floats(0.0, 0.3),
       mode=st.sampled_from(["auto", "incremental", "full"]))
def test_compact_equals_reference_incl_save_load(tmp_path_factory, seed, n,
                                                 back_p, mode):
    if mode == "incremental" and back_p > 0:
        back_p = 0.0             # cycle-closing streams need the fallback
    rng = np.random.default_rng(seed)
    g = ref_gen.random_dag(n, 1.5, seed=seed + 2)
    tmp = tmp_path_factory.mktemp("c")
    ref, port = _pair(tmp / "a", g, k=2, variant="G", phase2_mode="sparse",
                      n_seeds=8, overlay_cap=128, min_bucket=64,
                      max_batch=512)
    for src, dst in _insert_batches(rng, n, 2, 20, back_p):
        port.apply_updates(src, dst)
        ref.apply_updates(src, dst)
    qs = rng.integers(0, n, size=400)
    qt = rng.integers(0, n, size=400)
    before = _same(ref, port, qs, qt)
    assert port.compact(mode=mode).builder == ref.compact(mode=mode).builder
    _same_labels(port.index, ref.index)
    np.testing.assert_array_equal(_same(ref, port, qs, qt), before)
    reach.save_index(tmp / "b", port.index, port.spec, epoch=port.epoch)
    loaded = reach.QuerySession.load(tmp / "b", device="cpu")
    np.testing.assert_array_equal(loaded.query(qs, qt), before)
