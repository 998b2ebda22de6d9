"""Sparse phase 2 of the port on the CPU: kernels 3 and 4 (plain versions)
and the fused-step BFS loop against the reference's fused loop run with
its Pallas kernels in interpret mode — equal in ``pos`` AND in the overflow
flag, small caps that overflow included — plus the key-packing boundary
and guards (cf. tests/test_frontier_fused.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import reach as ref_reach
from repro.core.ferrari import build_index as ref_build
from repro.core.packed import pack_index as ref_pack
from repro.core.query import brute_force_closure
from repro.graphs import generators as ref_gen
from repro.kernels.frontier import expand_frontier as ref_expand_xla
from repro.kernels.frontier_fused import (_classify_call, _probe_kernel,
                                          _row_call)
from repro.kernels.frontier_fused import \
    expand_frontier_fused as ref_expand_fused
from repro_torch import reach
from repro_torch.core.ferrari import build_index
from repro_torch.core.packed import pack_index
from repro_torch.core.workload import positive_queries, random_queries
from repro_torch.graphs import generators as gen
from repro_torch.kernels import frontier_fused as ff
from repro_torch.kernels import ops
from repro_torch.kernels.frontier import (SENTINEL, _bit, key_bits,
                                          max_batch, or_bits)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _setup(graph, k, variant, use_seeds, n_seeds=32, ell_width=None):
    """The same index built by both packages (identical by
    test_torch_build), as (port dict, port layout, ref dict, ref layout)."""
    kw = dict(k=k, variant=variant, use_seeds=use_seeds, n_seeds=n_seeds)
    p_ref = ref_pack(ref_build(graph(ref_gen), **kw))
    p = pack_index(build_index(graph(gen), **kw))
    ell, tsrc, tdst = p.ell_layout(width=ell_width)
    is_hub = np.zeros(p.n, bool)
    is_hub[tsrc] = True
    layout = tuple(_t(a) for a in (ell, tsrc, tdst, is_hub))
    ref_layout = tuple(jnp.asarray(a) for a in (ell, tsrc, tdst, is_hub))
    return p, p.to_torch("cpu"), layout, p_ref.to_device(), ref_layout


def _queries(g, p, n_rand, n_pos, seed):
    qs, qt = random_queries(g, n_rand, seed=seed)
    ps, pt = positive_queries(g, n_pos, seed=seed + 1)
    qs, qt = np.concatenate([qs, ps]), np.concatenate([qt, pt])
    return p.comp[qs].astype(np.int32), p.comp[qt].astype(np.int32)


def _run_both(p, dev, layout, dev_ref, ref_layout, cs, ct, pad, cap):
    got = ops.expand_frontier(dev, *layout, _t(cs), _t(ct), _t(pad),
                              max_steps=p.n, cap=cap)
    want = ref_expand_fused(dev_ref, *ref_layout, jnp.asarray(cs),
                            jnp.asarray(ct), jnp.asarray(pad),
                            max_steps=p.n, cap=cap, interpret=True)
    return (got[0].numpy(), got[1]), (np.asarray(want[0]), bool(want[1]))


RANDOM = lambda m: m.random_dag(300, 2.0, seed=0)                # noqa: E731
LAYERED = lambda m: m.layered_dag(500, 20, 3.0, seed=3)          # noqa: E731
LAYERED_TAIL = lambda m: m.layered_dag(400, 16, 3.0, seed=4)     # noqa: E731
SCALE_FREE = lambda m: m.scale_free_digraph(400, 3.0, seed=5)    # noqa: E731


# ----------------------------------------------------- loop-level parity --
@pytest.mark.parametrize("graph,k,variant,seeds,width,cap", [
    (RANDOM, 2, "G", True, None, 4096),
    (SCALE_FREE, 2, "G", True, None, 32768),
    (LAYERED, 1, "L", False, None, 4096),
    # width=2 forces hubs into the COO tail: the tail sweep branch runs
    (LAYERED_TAIL, 1, "L", False, 2, 4096),
    # small caps: the conservative raw > cap+1 overflow rule fires
    (LAYERED, 1, "L", False, None, 512),
    (LAYERED_TAIL, 1, "L", False, 2, 320),
    (LAYERED, 1, "L", False, None, 330),
])
def test_loop_matches_reference_fused(graph, k, variant, seeds, width, cap):
    p, dev, layout, dev_ref, ref_layout = _setup(graph, k, variant, seeds,
                                                 ell_width=width)
    cs, ct = _queries(graph(gen), p, 256, 64, seed=9)
    pad = np.zeros(cs.size, bool)
    pad[::37] = True                           # padding slots never expand
    (pa, ova), (pb, ovb) = _run_both(p, dev, layout, dev_ref, ref_layout,
                                     cs, ct, pad, cap)
    assert ova == ovb
    np.testing.assert_array_equal(pa, pb)
    assert not pa[pad].any()
    if cap >= 4096:
        assert not ova and pa.any()


def test_overflow_positives_sound():
    g = LAYERED(gen)
    tc = brute_force_closure(g)
    p, dev, layout, dev_ref, ref_layout = _setup(LAYERED, 1, "L", False)
    qs, qt = random_queries(g, 256, seed=2)
    cs, ct = p.comp[qs].astype(np.int32), p.comp[qt].astype(np.int32)
    (pa, ova), (pb, ovb) = _run_both(p, dev, layout, dev_ref, ref_layout,
                                     cs, ct, np.zeros(256, bool), 512)
    assert ova and ovb
    np.testing.assert_array_equal(pa, pb)
    truth = np.array([tc[s, t] for s, t in zip(qs, qt)])
    assert not (pa & ~truth).any()


def test_loop_naive_layout_matches_reference_xla():
    """64 seeds: no fused layout, so survivors are classified by kernel 2
    plus the emit rule. The reference runs its XLA loop there; with no
    overflow both loops visit the same states."""
    p, dev, layout, dev_ref, ref_layout = _setup(SCALE_FREE, 1, "L", True,
                                                 n_seeds=64, ell_width=2)
    assert "slab" not in dev
    cs, ct = _queries(SCALE_FREE(gen), p, 256, 64, seed=3)
    pad = np.zeros(cs.size, bool)
    got = ops.expand_frontier(dev, *layout, _t(cs), _t(ct), _t(pad),
                              max_steps=p.n, cap=1 << 16)
    want = ref_expand_xla(dev_ref, *ref_layout, jnp.asarray(cs),
                          jnp.asarray(ct), jnp.asarray(pad),
                          max_steps=p.n, cap=1 << 16)
    assert not got[1] and not bool(want[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_naive_layout_overflow_rule_matches_reference_session():
    """64 seeds, k=1: the 12-array layout, where the reference runs its XLA
    loop, which overflows only on more than ``cap`` DISTINCT survivors.
    Here duplicate candidates push the raw survivor count past cap+1
    (the fused loop's conservative rule) while the distinct keys fit, so
    the reference does not retry, and neither may the port."""
    kw = dict(k=1, n_seeds=64, phase2_mode="sparse", phase2_chunk=16,
              frontier_cap=300, ell_width=8)
    g = gen.layered_dag(400, 8, 8.0, seed=1)
    qs, qt = random_queries(g, 1024, seed=1)
    spec_ref = ref_reach.IndexSpec(**kw)
    want_sess = ref_reach.QuerySession(
        ref_reach.build(ref_gen.layered_dag(400, 8, 8.0, seed=1), spec_ref),
        spec_ref)
    want = want_sess.query(qs, qt)
    spec = reach.IndexSpec(**kw)
    sess = reach.QuerySession(reach.build(g, spec), spec, device="cpu")
    assert "slab" not in sess.engine.dev
    got = sess.query(qs, qt)
    np.testing.assert_array_equal(got, want)
    assert want_sess.stats.phase2_sparse > 0
    assert sess.stats.phase2_sparse == want_sess.stats.phase2_sparse
    assert sess.stats.sparse_retries == want_sess.stats.sparse_retries == 0


# ------------------------------------------------------- kernel level ----
def _probe_inputs(rng, q, n, c):
    n_words = (n + 31) // 32
    cq = rng.integers(0, q, c).astype(np.int32)
    cv = rng.integers(0, n, c).astype(np.int32)
    ok = (rng.random(c) < 0.8).astype(np.int32)
    visited = rng.integers(0, 2**32, (q, n_words), dtype=np.uint32)
    visited[:, ::2] |= np.uint32(1 << 31)      # bit 31 set in half the words
    pos = (rng.random(q) < 0.2).astype(np.int32)
    return cq, cv, ok, visited, pos


@pytest.mark.parametrize("q,n,c", [(7, 100, 1000), (64, 5000, 3000)])
def test_probe_matches_pallas_interpret(q, n, c):
    rng = np.random.default_rng(q)
    cq, cv, ok, visited, pos = _probe_inputs(rng, q, n, c)
    vbits = key_bits(n)
    # the reference pre-gathers the visited word; the probe reads it itself
    cq0, cv0 = np.where(ok != 0, cq, 0), np.where(ok != 0, cv, 0)
    vw = visited[cq0, cv0 >> 5].view(np.int32)
    want = np.asarray(_row_call(
        functools.partial(_probe_kernel, vbits=vbits),
        tuple(jnp.asarray(a) for a in (cq0, cv0, ok, vw, pos[cq0])),
        block=256, interpret=True))
    got = ff.probe_plain(_t(cq), _t(cv), _t(ok),
                         _t(visited.view(np.int32)), _t(pos), vbits).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == SENTINEL).any() and (got != SENTINEL).any()


@pytest.mark.parametrize("k", [1, 4, 8])
def test_classify_emit_matches_pallas_interpret(k):
    from test_torch_phase1 import _packed_tables
    rng = np.random.default_rng(k)
    meta, slab = _packed_tables(rng, 400, k)
    c = 700
    cs = rng.integers(0, 400, c)
    ct = rng.integers(0, 400, c)
    ct[:50] = cs[:50]
    keys = np.where(rng.random(c) < 0.8,
                    rng.integers(0, 2**30, c), SENTINEL).astype(np.int32)
    eq = (cs == ct).astype(np.int32)
    args = (meta[cs], meta[ct], slab[cs], keys, eq)
    wv, wf = _classify_call(*(jnp.asarray(a) for a in args[:4]),
                            jnp.asarray(eq != 0), block=256, interpret=True)
    gv, gf = ff.classify_emit_plain(*(_t(a) for a in args))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    assert set(np.unique(gv.numpy())) == {0, 1, 2}


def test_unique_fixed_matches_jnp_unique():
    rng = np.random.default_rng(0)
    for size in (5, 1000):
        x = rng.integers(0, 40, size).astype(np.int32)
        x[rng.random(size) < 0.3] = SENTINEL
        want = np.asarray(jnp.unique(jnp.asarray(x), size=size,
                                     fill_value=SENTINEL))
        np.testing.assert_array_equal(ff.unique_fixed(_t(x)).numpy(), want)


def test_bit_and_or_bits_match_uint32():
    v = torch.arange(0, 96, dtype=torch.int32)
    want = (np.uint32(1) << (np.arange(96) & 31).astype(np.uint32))
    np.testing.assert_array_equal(_bit(v).numpy(), want.view(np.int32))
    words = torch.zeros((2, 3), dtype=torch.int32)
    rows = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    nodes = torch.tensor([31, 3, 95, 64, 33], dtype=torch.int32)
    or_bits(words, rows, nodes >> 5, _bit(nodes))
    ref_w = np.zeros((2, 3), np.uint32)
    for r, x in zip(rows.tolist(), nodes.tolist()):
        ref_w[r, x >> 5] |= np.uint32(1 << (x & 31))
    np.testing.assert_array_equal(words.numpy(), ref_w.view(np.int32))


# ------------------------------------- key-space guards near 2**31 ------
def test_key_packing_boundary():
    for log_n in (10, 15, 20, 29, 30):
        n = 1 << log_n
        vb = key_bits(n)
        assert vb == log_n
        assert (((max_batch(n) - 1) << vb) | (n - 1)) < SENTINEL
        assert ((max_batch(n) << vb) | (n - 1)) == SENTINEL


def _dummy_loop_args(q):
    z = torch.zeros((4, 2), dtype=torch.int32)
    e = torch.zeros(0, dtype=torch.int32)
    zq = torch.zeros(q, dtype=torch.int32)
    return (z, e, e, torch.zeros(4, dtype=torch.bool), zq, zq,
            torch.zeros(q, dtype=torch.bool))


@pytest.mark.parametrize("n,q,cap,match", [
    (2**31, 4, 16, "at most 30"),                      # vbits too large
    (1 << 20, max_batch(1 << 20) + 2, max_batch(1 << 20) + 2, "max_batch"),
    (1000, 20, 16, "max_batch"),                       # q > cap
])
def test_keyspace_guards(n, q, cap, match):
    with pytest.raises(ValueError, match=match):
        ff.expand_frontier_loop_fused(
            *_dummy_loop_args(q), n_nodes=n, max_steps=1, cap=cap,
            gather_rows=lambda t, i: t[i.long()],
            fetch_rows=lambda c, t: (c, c, c))
