"""The port's CUDA kernels against their plain PyTorch versions, and the
engine, the recsys cells, the GNN forward, the LM's prefill and decode
(dense and MoE, the int8 KV cache), the LM train cell (dense and MoE),
the expert-parallel MoE at world 1 over NCCL and every cell kind on a
world-1 NCCL mesh on the card against the same on the CPU or without a
mesh. Needs a CUDA device:
every test here carries the ``cuda`` marker and skips without one. The
file imports neither JAX nor the reference package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import functools
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.core.build import build_wavefront
from repro_torch.core.query_torch import DeviceQueryEngine
from repro_torch.core.workload import random_queries
from repro_torch.graphs.generators import (add_hub_edges, layered_dag,
                                           scale_free_digraph)
from repro_torch.kernels import _lib
from repro_torch.kernels import frontier_fused as ff
from repro_torch.kernels.interval_stab import (stab_naive, stab_naive_plain,
                                               stab_packed,
                                               stab_packed_owned,
                                               stab_packed_owned_plain,
                                               stab_packed_plain)
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.kernels.batched_mp import batched_mp, batched_mp_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_bwd, flash_bwd_dkv,
                                                 flash_bwd_dq,
                                                 flash_bwd_plain, flash_fwd,
                                                 row_delta)
from repro_torch.kernels.merge_cover import merge_cover, merge_cover_plain
from repro_torch.kernels.retrieval_score import (retrieval_score,
                                                 retrieval_score_plain)
from repro_torch.launch import serve
from repro_torch.models import api, gnn, transformer
from repro_torch.reach import IndexSpec, QuerySession, build

pytestmark = pytest.mark.cuda
SENTINEL = 2**31 - 1
# float kernels: true float32 FMAs summed in another order than the plain
# version. Model outputs on the card against the CPU: rtol 1e-4, and atol
# 1e-5 times the output's scale (its largest magnitude, at least 1): the
# readout sums terms as large as the largest logit, so a logit near zero
# keeps the rounding of those terms (untrained gin-tu's logits reach ~100).
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# kernel 6 against its plain version: the reference tests' tolerances,
# 2e-5 in float32 and 3e-2 in bfloat16 (the kernel rounds the softmax
# numerators to bfloat16 before the product with v; the plain version
# does not)
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def forward_tol(want):
    return dict(rtol=1e-4, atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _i32(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)))


def _words(rng, shape):
    bit = rng.integers(0, 32, shape).astype(np.uint32)
    return np.where(rng.random(shape) < 0.3, np.uint32(1) << bit,
                    np.uint32(0)).astype(np.uint32)


def _packed(rng, n, k):
    """meta [n, 4] / slab [n, 2K]: levels over the sign bit and saturated,
    exact flags in the sign bit of begins, INVALID pads, seed words."""
    pi = rng.integers(0, 1 << 24, n).astype(np.uint32)
    lvl = rng.choice(np.array([0, 5, 127, 128, 254, 255], np.uint32), n)
    meta = np.stack([(pi | (lvl << np.uint32(24))).view(np.int32),
                     rng.integers(0, 1000, n).astype(np.int32),
                     _words(rng, n).view(np.int32),
                     _words(rng, n).view(np.int32)], axis=1)
    near = pi[rng.integers(0, n, (n, k))].astype(np.int64)
    b = np.clip(near - rng.integers(0, 8, (n, k)), 0, None)
    e = near + rng.integers(0, 8, (n, k))
    invalid = rng.random((n, k)) < 0.2
    exact = (rng.random((n, k)) < 0.3) & ~invalid
    b = np.where(invalid, SENTINEL, b).astype(np.uint32)
    b |= exact.astype(np.uint32) << np.uint32(31)
    e = np.where(invalid, -1, e).astype(np.int32)
    return meta, np.concatenate([b.view(np.int32), e], axis=1)


def _pairs(rng, n, q):
    cs = rng.integers(0, n, q)
    ct = rng.integers(0, n, q)
    ct[: q // 8] = cs[: q // 8]
    return cs, ct


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _stab_pairs(rng, n, q, same):
    """(cs, ct) of ``_pairs``, or every pair with cs == ct."""
    if same:
        cs = rng.integers(0, n, q)
        return cs, cs.copy()
    return _pairs(rng, n, q)


# K odd, even and a multiple of 4 (the kernels' 1-, 2- and 4-wide loads;
# K 1, 2 and 4 one thread a query), up to 32 slots; Q of one query, less
# than a warp and not a multiple of a block; and a call where every pair
# folds (cs == ct)
@pytest.mark.parametrize("k,q,same", [
    *((k, 70_001, False) for k in (1, 2, 3, 4, 5, 8, 16, 32)),
    (8, 1, False), (3, 31, False), (8, 31, False), (8, 4096, True)])
def test_stab_packed_matches_plain(dev, k, q, same):
    rng = np.random.default_rng(k + q)
    meta, slab = _packed(rng, 5000, k)
    cs, ct = _stab_pairs(rng, 5000, q, same)
    args = [_i32(a) for a in (meta, slab, cs, ct)]
    before = _lib.LAUNCHES["stab_packed"]
    _same(stab_packed(*(a.to(dev) for a in args)), stab_packed_plain(*args))
    assert _lib.LAUNCHES["stab_packed"] == before + 1


@pytest.mark.parametrize("k,w,q,same", [
    *((k, w, 50_000, False) for k, w in (
        (1, 2), (8, 2), (32, 1), (3, 0), (1, 0), (5, 3), (7, 1), (2, 3),
        (16, 0), (31, 2))),
    (1, 2, 1, False), (3, 3, 31, False), (1, 2, 70_001, False),
    (1, 2, 4096, True)])
def test_stab_naive_matches_plain(dev, k, w, q, same):
    rng = np.random.default_rng(k + w + q)
    n = 6000
    pi = rng.integers(0, 1 << 26, n)
    near = pi[rng.integers(0, n, (n, k))]
    b = np.clip(near - rng.integers(0, 8, (n, k)), 0, None)
    e = near + rng.integers(0, 8, (n, k))
    invalid = rng.random((n, k)) < 0.2
    tables = [_i32(a) for a in (
        pi, rng.integers(0, 1000, n), rng.integers(0, 400, n),
        np.where(invalid, SENTINEL, b), np.where(invalid, -1, e),
        (rng.random((n, k)) < 0.3) & ~invalid,
        _words(rng, (n, w)), _words(rng, (n, w)))]
    cs, ct = (_i32(a) for a in _stab_pairs(rng, n, q, same))
    before = _lib.LAUNCHES["stab_naive"]
    _same(stab_naive(*(t.to(dev) for t in tables), cs.to(dev), ct.to(dev)),
          stab_naive_plain(*tables, cs, ct))
    assert _lib.LAUNCHES["stab_naive"] == before + 1


@functools.lru_cache(maxsize=None)
def _sparse_index(k, n_seeds):
    from repro_torch.core.packed import pack_index
    g = layered_dag(20_000, 40, 3.0, seed=3)
    spec = (IndexSpec(k=k, use_seeds=False) if n_seeds is None
            else IndexSpec(k=k, n_seeds=n_seeds))
    return pack_index(build(g, spec))


def _sparse_setup(dev, width=2, n_seeds=None, k=1):
    """A weak index (budget ``k``) over a 20,000-node layered DAG with hubs
    in the COO tail (ELL width 2), whose phase-2 queries run several steps:
    the packed index, its CPU tables and the BFS tables on ``dev`` and on
    the CPU."""
    p = _sparse_index(k, n_seeds)
    ell, tsrc, tdst = p.ell_layout(width=width)
    is_hub = np.zeros(p.n, bool)
    is_hub[tsrc] = True
    tables = dict(ell=_i32(ell), tail_src=_i32(tsrc), tail_dst=_i32(tdst),
                  is_hub=torch.from_numpy(is_hub))
    cpu = p.to_torch("cpu")
    if "slab" in cpu:
        tables.update(meta=cpu["meta"], slab=cpu["slab"])
    return p, cpu, {k: v.to(dev) for k, v in tables.items()}, tables


def _queries(p, cpu, q, seed):
    """Q pairs of condensed ids that phase 1 leaves UNKNOWN (phase 2's
    traffic)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, p.n, 40 * q).astype(np.int32)
    ct = rng.integers(0, p.n, 40 * q).astype(np.int32)
    v = ops.classify_queries(cpu, _i32(cs), _i32(ct)).numpy()
    unknown = np.flatnonzero(v == ops.UNKNOWN)[:q]
    assert unknown.size == q
    return cs[unknown], ct[unknown]


def _replay(st, tables, cs, pad, **kw):
    """The loop stepped from the host with the standalone kernels
    (``_stepped_call``): the state before each step (clones)."""
    states = []
    ff._stepped_call(st, tables, cs, tables["ct"], pad,
                     on_step=lambda s: states.append(s.clone()), **kw)
    return states


def _hold_state(got, want, after_probe=False):
    """Two StepStates equal word for word (the launch counters aside, which
    the plain versions leave alone, and ctl's tile counter after kernel 3
    alone)."""
    a, b = got.state.cpu().clone(), want.state.cpu().clone()
    a[ff.LAUNCH_WORDS] = b[ff.LAUNCH_WORDS] = 0
    if after_probe:
        a[ff.TILE] = b[ff.TILE] = 0
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    ctl = b.tolist()
    for name in ("visited", "fbits", "slots"):
        x, y = getattr(got, name), getattr(want, name)
        if x is not None:
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    np.testing.assert_array_equal(
        got.front[:ctl[ff.N_FRONT]].cpu().numpy(),
        want.front[:ctl[ff.N_FRONT]].cpu().numpy())
    np.testing.assert_array_equal(got.log[:ctl[ff.LOG_N]].cpu().numpy(),
                                  want.log[:ctl[ff.LOG_N]].cpu().numpy())


# cap 64 overflows (raw > cap + 1), 4096 is the default, 32768 takes
# kernel 4's two-launch form (above one block's sort)
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("cap", [64, 4096, 32768])
def test_probe_matches_plain(dev, cap, k):
    """Kernel 3 against expand_probe_plain, bit for bit, on every step of
    a call with hubs in its fronts (the tail sweep)."""
    p, cpu, tables, tables_cpu = _sparse_setup(dev, k=k)
    cs, ct = _queries(p, cpu, 64, 1)
    pad = np.zeros(64, bool)
    pad[5] = True
    st = ff.StepState(q=64, n_nodes=p.n, w=2, m_t=int(tables["tail_src"]
                      .shape[0]), cap=cap, max_steps=p.n, device=dev)
    tables["ct"] = _i32(ct).to(dev)
    states = _replay(st, tables, _i32(cs).to(dev),
                     torch.from_numpy(pad).to(dev))
    assert len(states) >= (1 if cap == 64 else 2)
    assert any(int(s.ctl[ff.HUB]) for s in states)
    assert st.read()[ff.OVF] or cap != 64
    for s in states:
        got, want = s.clone(), s.clone()
        ff.expand_probe(got, tables)
        ff.expand_probe_plain(want, tables["ell"], tables["tail_src"],
                              tables["tail_dst"])
        _hold_state(got, want, after_probe=True)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("cap", [64, 4096])
def test_probe_rows_matches_plain(dev, cap, k):
    """Kernel 3's exchanged-rows entry (the front's ELL rows from an
    [n_front, W] buffer) against its plain version, bit for bit, on every
    step of a call with hubs in its fronts, and against the in-place
    kernel on the same step."""
    p, cpu, tables, tables_cpu = _sparse_setup(dev, k=k)
    cs, ct = _queries(p, cpu, 64, 1)
    st = ff.StepState(q=64, n_nodes=p.n, w=2, m_t=int(tables["tail_src"]
                      .shape[0]), cap=cap, max_steps=p.n, device=dev)
    tables["ct"] = _i32(ct).to(dev)
    states = _replay(st, tables, _i32(cs).to(dev),
                     torch.zeros(64, dtype=torch.bool, device=dev))
    assert any(int(s.ctl[ff.HUB]) for s in states)

    def gather(table, ids):
        return table[ids.long()]
    before = _lib.LAUNCHES["probe_rows"]
    for s in states:
        n_front = int(s.ctl[ff.N_FRONT])
        got, want, inplace = s.clone(), s.clone(), s.clone()
        ff.expand_probe(got, tables, gather_rows=gather, n_front=n_front)
        rows = ff.front_rows(want, tables["ell"], n_front, gather)
        ff.expand_probe_rows_plain(want, rows, tables["tail_src"],
                                   tables["tail_dst"])
        ff.expand_probe(inplace, tables)
        _hold_state(got, want, after_probe=True)
        _hold_state(got, inplace, after_probe=True)
    assert _lib.LAUNCHES["probe_rows"] - before == len(states)


@pytest.mark.parametrize("n_model", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_stab_packed_owned_matches_plain(dev, k, n_model):
    """Kernel 1's owned-rows entry against its plain version on each
    shard, bit for bit (0 where the shard does not own the source), and
    the shards' sum against kernel 1 on the whole tables."""
    rng = np.random.default_rng(k)
    n, q = 9_001, 70_001
    meta, slab = _packed(rng, n, k)
    cs, ct = _pairs(rng, n, q)
    cs_t, ct_t = _i32(cs).to(dev), _i32(ct).to(dev)
    meta_t = _i32(meta[ct]).to(dev)
    n_loc = -(-n // n_model)
    total = torch.zeros(q, dtype=torch.int32, device=dev)
    for m in range(n_model):
        lo = m * n_loc
        rows = np.zeros((n_loc, 4), np.int32), np.zeros((n_loc, 2 * k),
                                                         np.int32)
        hi = min(lo + n_loc, n)
        rows[0][:hi - lo], rows[1][:hi - lo] = meta[lo:hi], slab[lo:hi]
        got = stab_packed_owned(meta_t, _i32(rows[0]).to(dev),
                                _i32(rows[1]).to(dev), cs_t, ct_t, lo)
        want = stab_packed_owned_plain(_i32(meta[ct]), _i32(rows[0]),
                                       _i32(rows[1]), _i32(cs), _i32(ct), lo)
        _same(got, want)
        total += got
    _same(total, stab_packed_plain(_i32(meta), _i32(slab), _i32(cs),
                                   _i32(ct)))


@pytest.mark.parametrize("placement", ["replicated", "sharded"])
def test_world_one_nccl_engine_matches_single(dev, tmp_path, placement):
    """A world-1 NCCL process group (mesh 1x1): the distributed session on
    the card answers as the one-device session, with its phase mix; the
    sharded one through kernel 1's owned-rows entry and kernel 3's
    exchanged-rows entry (its loop stepped from the host)."""
    import torch.distributed as dist
    g = scale_free_digraph(20_000, 4.0, seed=0)
    base = dict(k=1, use_seeds=False, phase2_mode="sparse", phase2_chunk=64,
                frontier_cap=64, max_batch=4096, min_bucket=256)
    ix = build(g, IndexSpec(**base))
    qs, qt = random_queries(g, 20_000, seed=2)
    single = QuerySession(ix, IndexSpec(**base))
    want = single.query(qs, qt)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        _lib.LAUNCHES.reset()
        sess = QuerySession(ix, IndexSpec(**base, placement=placement))
        np.testing.assert_array_equal(sess.query(qs, qt), want)
        got, ref = asdict(sess.stats), asdict(single.stats)
        for d in (got, ref):
            for key in ("seconds", "sparse_retries", "buckets"):
                d.pop(key)
        assert got == ref and sess.stats.phase2_sparse > 0
        own = placement == "sharded"
        assert (_lib.LAUNCHES["stab_packed_owned"] > 0) == own
        assert (_lib.LAUNCHES["probe_rows"] > 0) == own
        assert (_lib.LAUNCHES["stab_packed"] > 0) != own
        assert _lib.LAUNCHES["classify_emit"] > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("cap", [64, 4096, 32768])
def test_classify_emit_matches_plain(dev, cap, k):
    """Kernel 4 (one block up to 16,384 slots, mark + emit above) against
    dedup_classify_emit_plain, bit for bit, after kernel 3 on every step;
    cap 64 overflows. k 8 reads slab rows of K > 1."""
    p, cpu, tables, tables_cpu = _sparse_setup(dev, k=k)
    cs, ct = _queries(p, cpu, 64, 2)
    st = ff.StepState(q=64, n_nodes=p.n, w=2, m_t=int(tables["tail_src"]
                      .shape[0]), cap=cap, max_steps=p.n, device=dev)
    tables["ct"] = _i32(ct).to(dev)
    states = _replay(st, tables, _i32(cs).to(dev),
                     torch.zeros(64, dtype=torch.bool, device=dev))
    meta, slab = tables["meta"], tables["slab"]
    ovf = False
    for s in states:
        ff.expand_probe(s, tables)
        got, want = s.clone(), s.clone()
        ff.dedup_classify_emit(got, tables)
        ff.dedup_classify_emit_plain(
            want, tables["ct"], tables["is_hub"],
            fetch_rows=lambda c, t: (meta[c.long()], meta[t.long()],
                                     slab[c.long()]),
            classify=ff.classify_emit_plain)
        _hold_state(got, want)
        ovf |= bool(want.ctl[ff.OVF])
    assert ovf or cap != 64


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("cap,max_steps", [(64, None), (4096, None),
                                           (4096, 2)])
def test_sparse_loop_on_card_matches_cpu(dev, cap, max_steps, k):
    """The card's loop (one graph a call) against the CPU loop, pos and
    overflow, over chunks of one engine: kernels 3 and 4 once a step and
    set-up and clean-up once a call, as the kernels counted their own
    launches; one sync a call; the visited bitset zero between calls; a
    step budget of 2 stops both loops after two steps."""
    from repro_torch.kernels import ops
    p, cpu, tables, tables_cpu = _sparse_setup(dev, k=k)
    gpu_dev = p.to_torch(dev)
    cache = {}
    for seed in range(4):
        cs, ct = _queries(p, cpu, 64, seed)
        pad = np.zeros(64, bool)
        pad[::11] = True
        args = [_i32(cs), _i32(ct), torch.from_numpy(pad)]
        layout = ("ell", "tail_src", "tail_dst", "is_hub")
        steps_cap = max_steps or p.n
        want = ops.expand_frontier(cpu, *(tables_cpu[k] for k in layout),
                                   *args, max_steps=steps_cap, cap=cap)
        ff.STEPS.reset()
        before = dict(_lib.LAUNCHES)
        got = ops.expand_frontier(
            gpu_dev, *(tables[k] for k in layout),
            *(a.to(dev) for a in args), max_steps=steps_cap, cap=cap,
            workspaces=cache)
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        assert got[1] == want[1]
        steps = ff.STEPS["steps"]
        assert steps > 0 and ff.STEPS["syncs"] == 1
        assert max_steps is None or steps <= max_steps
        assert ff.STEPS["launches"] == 2 * steps
        assert ff.STEPS["helpers"] == 2
        for name in ("probe", "classify_emit"):
            assert _lib.LAUNCHES[name] - before[name] == steps
        (st,) = cache.values()
        assert not st.visited.any() and not st.fbits.any()
    assert cap != 64 or got[1]


def test_naive_layout_step_kernels_match_plain(dev):
    """The 12-array layout's step: kernel 3 keeping every survivor, the
    distinct-count unique, kernel 2's verdicts, kernel 4's mark and emit,
    against the plain step with kernel 2's plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.interval_stab import stab_naive
    p, cpu, tables, tables_cpu = _sparse_setup(dev, n_seeds=64)
    assert "slab" not in cpu
    gpu_dev = p.to_torch(dev)
    sp, sm = ops.ref.naive_seed_rows(gpu_dev)
    naive = (gpu_dev["pi"], gpu_dev["tau"], gpu_dev["blevel"],
             gpu_dev["begins"], gpu_dev["ends"], gpu_dev["exact"], sp, sm)

    def classify(cands, tgts, keys, eq):
        return ff.emit_plain(stab_naive(*naive, cands, tgts), keys)

    def classify_plain(cands, tgts, keys, eq):
        return ff.emit_plain(stab_naive_plain(*(t.cpu() for t in naive),
                                              cands.cpu(), tgts.cpu())
                             .to(dev), keys)
    cs, ct = _queries(p, cpu, 64, 3)
    cap = 300
    st = ff.StepState(q=64, n_nodes=p.n, w=2, m_t=int(tables["tail_src"]
                      .shape[0]), cap=cap, max_steps=p.n, device=dev)
    tables["ct"] = _i32(ct).to(dev)
    states = _replay(st, tables, _i32(cs).to(dev),
                     torch.zeros(64, dtype=torch.bool, device=dev),
                     classify=classify, distinct_overflow=True)
    assert len(states) >= 2
    for s in states:
        got, want = s.clone(), s.clone()
        ff.expand_probe(got, tables)
        ff.expand_probe_plain(want, tables["ell"], tables["tail_src"],
                              tables["tail_dst"])
        _hold_state(got, want, after_probe=True)
        ff.dedup_classify_emit(got, tables, classify=classify,
                               distinct_overflow=True)
        ff.dedup_classify_emit_plain(
            want, tables["ct"], tables["is_hub"],
            fetch_rows=lambda c, t: (c, t), classify=classify_plain,
            distinct_overflow=True)
        _hold_state(got, want)


@pytest.mark.parametrize("n_seeds,cap", [(None, 64), (None, 4096),
                                          (None, 32768), (64, 300)])
def test_overlay_classify_emit_matches_plain(dev, n_seeds, cap):
    """Kernel 4 with a live overlay's ``can_reach_tail`` (read in place,
    random here: half the nodes) against dedup_classify_emit_plain with
    the same gate, word for word, after kernel 3 on every step of a
    call: the one-block form, mark + emit above 16,384 slots, and the
    12-array layout (kernel 2's verdicts through the rule in mark)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.interval_stab import stab_naive
    p, cpu, tables, tables_cpu = _sparse_setup(dev, n_seeds=n_seeds)
    rng = np.random.default_rng(7)
    crt = torch.from_numpy(rng.random(p.n) < 0.5).to(dev)
    tables["can_reach_tail"] = crt
    kw, plain_kw = {}, {}
    if n_seeds is None:
        meta, slab = tables["meta"], tables["slab"]
        plain_kw = dict(fetch_rows=lambda c, t: (meta[c.long()],
                                                 meta[t.long()],
                                                 slab[c.long()]),
                        classify=ff.classify_emit_plain)
    else:
        gpu_dev = p.to_torch(dev)
        sp, sm = ops.ref.naive_seed_rows(gpu_dev)
        naive = (gpu_dev["pi"], gpu_dev["tau"], gpu_dev["blevel"],
                 gpu_dev["begins"], gpu_dev["ends"], gpu_dev["exact"], sp,
                 sm)

        def classify(cands, tgts, keys, eq):
            return ff.emit_plain(stab_naive(*naive, cands, tgts), keys)

        def classify_plain(cands, tgts, keys, eq):
            return ff.emit_plain(stab_naive_plain(
                *(t.cpu() for t in naive), cands.cpu(), tgts.cpu()).to(dev),
                keys)
        kw = dict(classify=classify, distinct_overflow=True)
        plain_kw = dict(fetch_rows=lambda c, t: (c, t),
                        classify=classify_plain, distinct_overflow=True)
    cs, ct = _queries(p, cpu, 64, 4)
    st = ff.StepState(q=64, n_nodes=p.n, w=2, m_t=int(tables["tail_src"]
                      .shape[0]), cap=cap, max_steps=p.n, device=dev)
    tables["ct"] = _i32(ct).to(dev)
    states = _replay(st, tables, _i32(cs).to(dev),
                     torch.zeros(64, dtype=torch.bool, device=dev), **kw)
    assert len(states) >= (1 if cap == 64 else 2)
    reopened = 0
    for s in states:
        ff.expand_probe(s, tables)
        got, want = s.clone(), s.clone()
        ff.dedup_classify_emit(got, tables, **kw)
        ff.dedup_classify_emit_plain(want, tables["ct"], tables["is_hub"],
                                     can_reach_tail=crt, **plain_kw)
        _hold_state(got, want)
        off = s.clone()
        ff.dedup_classify_emit_plain(off, tables["ct"], tables["is_hub"],
                                     **plain_kw)
        reopened += int(want.ctl[ff.N_FRONT]) - int(off.ctl[ff.N_FRONT])
    assert reopened > 0          # the gate kept NEG survivors in the front


def test_overlay_graph_captured_once_across_add_batches(dev):
    """Four add batches on a card session: the union tables keep their
    buffers, so the engine keeps one overlay loop state and one captured
    graph; every overlay call is that graph (one sync a call), and the
    answers equal the CPU session's after every batch."""
    g = scale_free_digraph(20_000, 4.0, seed=0)
    # caps up to 16,384 only: every overlay call is a graph call
    spec = IndexSpec(k=1, use_seeds=False, phase2_mode="sparse",
                     max_batch=4096, min_bucket=256, overlay_cap=4096,
                     frontier_cap_max=16384)
    ix = build(g, spec)
    cpu = QuerySession(ix, spec, device="cpu")
    gpu = QuerySession(ix, spec, device=dev)
    rng = np.random.default_rng(11)
    qs, qt = random_queries(g, 4096, seed=3)
    graphs, keys = set(), []
    for _ in range(4):
        src = rng.integers(0, g.n, 1024)
        dst = rng.integers(0, g.n, 1024)
        assert gpu.apply_updates(src, dst) == cpu.apply_updates(src, dst)
        want = cpu.query(qs, qt)
        ff.STEPS.reset()
        _lib.LAUNCHES.reset()
        np.testing.assert_array_equal(gpu.query(qs, qt), want)
        assert gpu.stats.n_overlay_hits == cpu.stats.n_overlay_hits
        states = gpu.engine._sparse_state
        overlay = {st.cap: st for st in states.values()
                   if st.tables["can_reach_tail"] is not None}
        assert overlay[spec.frontier_cap].graph is not None
        graphs.add(overlay[spec.frontier_cap].graph)
        keys.append(set(states))
        calls = ff.STEPS["helpers"] // 2
        assert calls > 0 and ff.STEPS["syncs"] == calls
        assert _lib.LAUNCHES["probe"] == ff.STEPS["steps"]
    # a later batch adds a state only for a cap no earlier one retried at
    assert len(graphs) == 1 and all(a <= b for a, b in zip(keys, keys[1:]))
    assert gpu.stats.n_overlay_hits > 0


def test_wrappers_refuse_bad_operands(dev):
    meta = torch.zeros((8, 4), dtype=torch.int32, device=dev)
    slab = torch.zeros((8, 4), dtype=torch.int32, device=dev)
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        stab_packed(meta, slab, idx.long(), idx)
    with pytest.raises(ValueError):
        stab_packed(meta, slab.t(), idx, idx)
    with pytest.raises(ValueError):
        stab_packed(meta.cpu(), slab, idx, idx)
    # K 4 takes 16-byte loads: a slab 4 bytes off that alignment is refused
    shifted = torch.zeros(65, dtype=torch.int32, device=dev)[1:].view(8, 8)
    with pytest.raises(ValueError):
        stab_packed(meta, shifted, idx, idx)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_engine_on_card_matches_cpu(dev, mode):
    g = layered_dag(500, 20, 3.0, seed=3)
    ix = build(g, IndexSpec(k=1, variant="L", use_seeds=False))
    qs, qt = random_queries(g, 3000, seed=1)
    cpu = DeviceQueryEngine(ix, device="cpu", phase2_mode=mode)
    gpu = DeviceQueryEngine(ix, device=dev, phase2_mode=mode)
    np.testing.assert_array_equal(gpu.answer(qs, qt), cpu.answer(qs, qt))
    assert asdict(gpu.stats) == asdict(cpu.stats)
    assert gpu.stats.phase2_queries > 0


def test_session_on_card_goes_through_kernels(dev):
    g = scale_free_digraph(20_000, 4.0, seed=0)
    # chunks of 64 at cap 64 overflow (cf. tests/test_frontier_sparse.py)
    spec = IndexSpec(k=1, use_seeds=False, phase2_mode="sparse",
                     phase2_chunk=64, frontier_cap=64, max_batch=4096,
                     min_bucket=256)
    ix = build(g, spec)
    qs, qt = random_queries(g, 20_000, seed=2)
    want = QuerySession(ix, spec, device="cpu").query(qs, qt)
    _lib.LAUNCHES.reset()
    sess = QuerySession(ix, spec)               # device="cuda" by default
    np.testing.assert_array_equal(sess.query(qs, qt), want)
    assert sess.stats.sparse_retries > 0
    assert all(_lib.LAUNCHES[k] > 0
               for k in ("stab_packed", "probe", "classify_emit"))
    with pytest.raises(ValueError):
        QuerySession(ix, IndexSpec(kernel_impl="xla"))


def _frontend_index():
    g = scale_free_digraph(20_000, 4.0, seed=5)
    spec = IndexSpec(k=1, use_seeds=False, phase2_mode="sparse",
                     phase2_chunk=64, frontier_cap=64, max_batch=4096,
                     min_bucket=256, tenant_queue_cap=4096)
    return g, spec, build(g, spec)


def test_frontend_on_card_matches_session(dev):
    """The async frontend on the card (pinned staging,
    kernels 1, 3, 4) answers every ticket as the session does, on the
    card and on the CPU."""
    from repro_torch.reach import Frontend, Rejected
    g, spec, ix = _frontend_index()
    qs, qt = random_queries(g, 30_000, seed=4)
    want = QuerySession(ix, spec, device="cpu").query(qs, qt)
    sess = QuerySession(ix, spec)
    _lib.LAUNCHES.reset()
    fe = Frontend(sess)
    tickets = {}
    for i, lo in enumerate(range(0, qs.size, 64)):
        while True:
            try:
                tickets[fe.submit(f"t{i % 8}", qs[lo:lo + 64],
                                  qt[lo:lo + 64])] = lo
                break
            except Rejected as e:
                assert e.reason == "queue_full"
                fe.poll()
    got = fe.drain()
    assert got.keys() == tickets.keys()
    for t, lo in tickets.items():
        np.testing.assert_array_equal(got[t], want[lo:lo + 64])
    np.testing.assert_array_equal(sess.query(qs, qt), want)
    assert all(_lib.LAUNCHES[k] > 0
               for k in ("stab_packed", "probe", "classify_emit"))
    assert fe.stats.n_batches > 1
    # two pinned buffers serve the whole double-buffered stream
    assert sess.engine._pinned.n_allocated <= 2


def test_staged_buffers_not_overwritten_with_two_batches_alive(dev):
    """Two staged batches hold two pinned buffers; a third stage while
    both are alive allocates a buffer of its own; each batch answers for
    its own ids; a finished batch's buffer is reused."""
    g, spec, ix = _frontend_index()
    sess = QuerySession(ix, spec)
    pool = sess.engine._pinned
    rng = np.random.default_rng(3)
    qs, qt = rng.integers(0, g.n, (2, 3 * 4096))
    want = QuerySession(ix, spec, device="cpu").query(qs, qt)
    parts = [slice(i * 4096, (i + 1) * 4096) for i in range(3)]
    a = sess.stage(qs[parts[0]], qt[parts[0]])
    b = sess.stage(qs[parts[1]], qt[parts[1]])
    ha = sess.begin(a)
    c = sess.stage(qs[parts[2]], qt[parts[2]])        # a and b alive
    bufs = {x.ids.buf.data_ptr() for x in (a, b, c)}
    assert len(bufs) == 3 and pool.n_allocated == 3
    got_a = sess.finish(ha)
    d = sess.stage(qs[parts[0]], qt[parts[0]])        # a's buffer, reused
    assert d.ids.buf.data_ptr() in bufs and pool.n_allocated == 3
    got_c = sess.finish(sess.begin(c))
    got_b = sess.finish(sess.begin(b))
    got_d = sess.finish(sess.begin(d))
    np.testing.assert_array_equal(got_a, want[parts[0]])
    np.testing.assert_array_equal(got_b, want[parts[1]])
    np.testing.assert_array_equal(got_c, want[parts[2]])
    np.testing.assert_array_equal(got_d, want[parts[0]])


def test_ferrari_cell_on_card_matches_cpu(dev):
    """ferrari-web's SMOKE cell: kernel 1 over the fused tables equals
    the plain version's verdicts, one launch a step."""
    from repro_torch.core.packed import pack_index
    cfg = get_smoke("ferrari-web")
    g = scale_free_digraph(cfg.n_nodes, 4.0, seed=3, back_p=0.0)
    ix = build(g, IndexSpec.from_config(cfg, precondensed=True))
    pk = pack_index(ix, k_max=cfg.k_max)
    cell = api.build_cell(cfg, "classify_100k", device=dev)
    cpu_cell = api.build_cell(cfg, "classify_100k", device="cpu")
    (q,), _ = cell.batch_shapes["cs"]
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.n_nodes, q).astype(
        np.int32)) for k in ("cs", "ct")}
    tables = pk.to_torch("cpu")
    state = {k: tables[k] for k in ("slab", "meta")}
    _, want = cpu_cell.step(state, batch)
    _lib.LAUNCHES.reset()
    _, got = cell.step({k: v.to(dev) for k, v in state.items()},
                       {k: v.to(dev) for k, v in batch.items()})
    assert _lib.LAUNCHES["stab_packed"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_naive_layout_sparse_on_card_matches_cpu(dev):
    """64 seeds: the 12-array layout, whose sparse phase 2 classifies
    survivors with kernel 2 inside the BFS loop."""
    g = scale_free_digraph(20_000, 4.0, seed=0)
    spec = IndexSpec(k=1, n_seeds=64, phase2_mode="sparse", max_batch=4096,
                     min_bucket=256)
    ix = build(g, spec)
    qs, qt = random_queries(g, 20_000, seed=2)
    cpu = QuerySession(ix, spec, device="cpu")
    want = cpu.query(qs, qt)
    _lib.LAUNCHES.reset()
    sess = QuerySession(ix, spec, device=dev)
    assert "slab" not in sess.engine.dev
    np.testing.assert_array_equal(sess.query(qs, qt), want)
    assert asdict(sess.engine.stats) == asdict(cpu.engine.stats)
    assert sess.stats.phase2_sparse > 0
    assert _lib.LAUNCHES["stab_naive"] > 0 and _lib.LAUNCHES["probe"] > 0


def _cover_rows(rng, rows, m, spread):
    """Begin-sorted rows with INVALID tails: empty rows, equal begins,
    touching intervals, equal gaps, and begins next to INVALID."""
    n_iv = rng.integers(0, m + 1, rows)
    n_iv[::7] = 0
    b = np.sort(rng.integers(0, spread, (rows, m)), axis=1)
    b[1::5] = b[1::5, :1]                                # all begins equal
    b[2::5] = 9 * np.arange(m)                           # equal gaps
    e = b + rng.integers(0, 6, (rows, m))
    e[3::5] = b[3::5] + 2                                # touching runs
    b[4::11] = SENTINEL - 1 - np.arange(m)[::-1]         # near INVALID
    e[4::11] = b[4::11]
    x = rng.random((rows, m)) < 0.5
    dead = np.arange(m)[None, :] >= n_iv[:, None]
    return [_i32(a) for a in (np.where(dead, SENTINEL, b),
                              np.where(dead, -1, e), x & ~dead)]


@pytest.mark.parametrize("m,k,w_out", [(1, 1, 1), (9, 2, 2), (9, 8, 8),
                                       (65, 8, 8), (513, 8, 8),
                                       (2049, 32, 32), (65, 12, 8),
                                       (33, 3, 32),
                                       # begins staged up to m 32, outputs
                                       # up to w_out 64: each limit and one
                                       # past it
                                       (32, 8, 8), (33, 8, 8), (9, 8, 64),
                                       (9, 8, 65)])
def test_merge_cover_matches_plain(dev, m, k, w_out):
    rng = np.random.default_rng(m + k)
    # no multiple of a block's 128 rows: the last block is short
    rows = 20_000 if m < 100 else 600
    args = _cover_rows(rng, rows, m, spread=8 * m)
    before = _lib.LAUNCHES["merge_cover"]
    _same(merge_cover(*(a.to(dev) for a in args), k, w_out),
          merge_cover_plain(*args, k, w_out))
    assert _lib.LAUNCHES["merge_cover"] == before + 1
    with pytest.raises(ValueError):
        merge_cover(*(a.to(dev) for a in args), 40, w_out)


@pytest.mark.parametrize("variant", ["L", "G"])
def test_wavefront_build_on_card_matches_cpu(dev, variant):
    g = add_hub_edges(layered_dag(3000, 12, 3.0, seed=4), 700, seed=5)
    kw = dict(k=2, variant=variant, merge_chunk=8, m_cap=129)
    want = build_wavefront(g, device="cpu", **kw)
    before = _lib.LAUNCHES["merge_cover"]
    got = build_wavefront(g, **kw)                  # device="cuda" default
    assert _lib.LAUNCHES["merge_cover"] > before
    assert got.hub_nodes >= 1 and got.merge_rounds >= 2
    for name in ("begins", "ends", "exact", "counts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("drain_order", "hub_nodes", "merge_rounds",
                 "host_fallbacks", "peak_slab_bytes"):
        assert getattr(got, name) == getattr(want, name)


def test_device_build_save_load_on_card(dev, tmp_path):
    from repro_torch.reach import save_index
    g = add_hub_edges(scale_free_digraph(20_000, 3.0, seed=1), 3000, seed=2)
    spec = IndexSpec(builder="wavefront", cover_method="topgap")
    ix = build(g, spec)                              # on the card
    assert ix.stats.hub_nodes >= 1 and ix.stats.host_fallbacks == 0
    save_index(tmp_path, ix, spec)
    qs, qt = random_queries(g, 20_000, seed=3)
    want = QuerySession(build(g, IndexSpec()), IndexSpec(),
                        device="cpu").query(qs, qt)
    sess = QuerySession.load(tmp_path)               # on the card
    assert sess.engine.device.type == "cuda"
    np.testing.assert_array_equal(sess.query(qs, qt), want)


def _close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


@pytest.mark.parametrize("c,d,i", [(1, 64, 4), (5000, 64, 4), (100, 16, 4),
                                   (2048, 32, 8), (777, 30, 5),
                                   (3001, 64, 12), (70_000, 64, 4)])
def test_retrieval_score_matches_plain(dev, c, d, i):
    rng = np.random.default_rng(c + d + i)
    cands = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    ints = torch.from_numpy(rng.standard_normal((i, d)).astype(np.float32))
    before = _lib.LAUNCHES["retrieval_score"]
    _close(retrieval_score(cands.to(dev), ints.to(dev)),
           retrieval_score_plain(cands, ints), KERNEL_TOL)
    assert _lib.LAUNCHES["retrieval_score"] == before + 1


def test_retrieval_score_edges(dev):
    rng = np.random.default_rng(9)
    ints = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    # rows 4 bytes off a 16-byte boundary take the scalar loads
    flat = torch.from_numpy(rng.standard_normal(999 * 64 + 1).astype(
        np.float32))
    cands = flat[1:].view(999, 64)
    _close(retrieval_score(cands.to(dev), ints.to(dev)),
           retrieval_score_plain(cands, ints), KERNEL_TOL)
    cands_dev = flat.to(dev)[1:].view(999, 64)
    assert cands_dev.data_ptr() % 16 != 0
    _close(retrieval_score(cands_dev, ints.to(dev)),
           retrieval_score_plain(cands, ints), KERNEL_TOL)
    before = _lib.LAUNCHES["retrieval_score"]
    assert retrieval_score(cands_dev[:0], ints.to(dev)).shape == (0,)
    assert _lib.LAUNCHES["retrieval_score"] == before
    nan_row = cands[:3].clone()
    nan_row[1, 5] = float("nan")
    assert torch.isnan(retrieval_score(nan_row.to(dev), ints.to(dev))[1])
    with pytest.raises(TypeError):
        retrieval_score(cands_dev.double(), ints.to(dev))
    with pytest.raises(ValueError):
        retrieval_score(cands_dev, ints[:0].to(dev))


@pytest.mark.parametrize("b,n,f,h", [
    (1, 8, 8, 8), (4, 16, 8, 12), (2, 32, 64, 16), (8, 30, 16, 2),
    (128, 30, 16, 16), (128, 30, 64, 64), (128, 30, 16, 128),
    (64, 30, 128, 128), (128, 30, 70, 70), (3, 128, 128, 128),
    (2, 200, 128, 128),
    # adj too large for one block: row tiles of adj
    (2, 240, 64, 64), (2, 256, 64, 64), (2, 384, 64, 64), (2, 512, 64, 64),
    (2, 1024, 64, 64),
    # the tensor-core route: pipelines short of graphs (B 1, 3, 127), its
    # edge (N 64) and the tiled route just past it (N 65)
    (1, 30, 64, 64), (3, 30, 64, 64), (127, 30, 64, 64), (4, 64, 64, 64),
    (4, 65, 64, 64)])
def test_batched_mp_matches_plain(dev, b, n, f, h):
    rng = np.random.default_rng(b + n + f + h)
    adj = (rng.random((b, n, n)) < 0.2).astype(np.float32)
    x = rng.standard_normal((b, n, f)).astype(np.float32)
    w = (rng.standard_normal((f, h)) * np.sqrt(2 / (f + h))).astype(
        np.float32)
    args = [torch.from_numpy(a) for a in (adj, x, w)]
    before = _lib.LAUNCHES["batched_mp"]
    _mp_close(batched_mp(*(a.to(dev) for a in args)), args)
    assert _lib.LAUNCHES["batched_mp"] == before + 1
    eye = torch.eye(f)
    _mp_close(batched_mp(args[0].to(dev), args[1].to(dev), eye.to(dev)),
              (args[0], args[1], eye))


def _mp_close(got, args):
    """Kernel 9 against its plain version: within KERNEL_TOL up to N 512.
    Beyond, a row of adj sums N/5 terms whose partial sums reach |agg|
    ~ 15, and the two float32 results each round by up to ~1e-5 in their
    own order: both are held against the float64 result, the kernel
    within KERNEL_TOL and its largest error at most twice the plain
    version's."""
    want = batched_mp_plain(*args)
    if args[0].shape[1] <= 512:
        _close(got, want, KERNEL_TOL)
        return
    exact = batched_mp_plain(*(a.double() for a in args))
    _close(got.double(), exact, KERNEL_TOL)
    err = float((got.cpu().double() - exact).abs().max())
    plain_err = float((want.double() - exact).abs().max())
    assert err <= 2 * plain_err, (err, plain_err)


def test_batched_mp_is_bit_reproducible(dev):
    """Two calls at the gnn path's bulk shape give the same bits: every
    output is summed in a fixed order, without atomics."""
    rng = np.random.default_rng(11)
    b, n, f = 65_536, 30, 64
    adj = torch.from_numpy((rng.random((b, n, n)) < 0.2).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((b, n, f)).astype(
        np.float32)).to(dev)
    for w in (torch.eye(f, device=dev), torch.randn((f, f), device=dev)):
        first = batched_mp(adj, x, w)
        assert torch.equal(batched_mp(adj, x, w), first)


def test_batched_mp_counts_one_launch_per_call_on_each_route(dev):
    """One count per call whatever the route: N 30 on the tensor cores,
    N 65 on the row-tiled kernel."""
    from repro_torch.kernels.batched_mp import route
    for n, want in ((30, "mma"), (65, "tiled")):
        assert route(n, 64, 64) == want
        adj = torch.ones((5, n, n), device=dev)
        x = torch.ones((5, n, 64), device=dev)
        before = dict(_lib.LAUNCHES)
        out = batched_mp(adj, x, torch.eye(64, device=dev))
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["batched_mp"] == before["batched_mp"] + 1
        assert {k: v for k, v in _lib.LAUNCHES.items()
                if k != "batched_mp"} == {k: v for k, v in before.items()
                                          if k != "batched_mp"}
        assert bool((out == n).all())


def test_batched_mp_refuses_a_graph_too_large(dev):
    """N 30,000: one row of adj beside one column of x is more than a
    block's shared memory. N 6,449 at F = H = 64: the tiles that fit take
    more blocks a graph than grid.y holds."""
    adj = torch.zeros((1, 30_000, 30_000), device=dev)
    x = torch.zeros((1, 30_000, 8), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        batched_mp(adj, x, torch.zeros((8, 8), device=dev))
    n = 6449
    with pytest.raises(ValueError, match="65535"):
        batched_mp(adj[:, :n, :n].contiguous(),
                   torch.zeros((1, n, 64), device=dev),
                   torch.zeros((64, 64), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        batched_mp(adj[:, :8, :8], x[:, :8], torch.zeros((8, 8), device=dev))


@pytest.mark.parametrize("shape_name", ["serve_p99", "retrieval_cand"])
def test_recsys_cell_on_card_matches_cpu(dev, shape_name):
    cfg = get_smoke("mind")
    shp = dataclasses.replace(shapes_for_family("recsys")[shape_name],
                              batch=64, n_candidates=5000)
    cpu = api.build_cell(cfg, shape_name, device="cpu", shape_override=shp)
    card = api.build_cell(cfg, shape_name, shape_override=shp)  # "cuda"
    assert card.device.type == "cuda"
    state = api.materialize_state(cpu, cfg, shape_name,
                                  torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {}
    for name, (shape, _) in cpu.batch_shapes.items():
        batch[name] = torch.from_numpy(
            (rng.random(shape) < 0.9).astype(np.float32)
            if name == "hist_mask" else
            rng.integers(0, cfg.n_items, shape).astype(np.int32))
    _, want = cpu.step(state, batch)
    _lib.LAUNCHES.reset()
    _, got = card.step(
        {"params": {k: v.to(dev) for k, v in state["params"].items()}},
        {k: v.to(dev) for k, v in batch.items()})
    _close(got, want, forward_tol(want))
    if shape_name == "retrieval_cand":
        assert _lib.LAUNCHES["retrieval_score"] == 1


@pytest.mark.parametrize("arch", ["gin-tu", "gcn-cora", "graphsage-reddit",
                                  "gatedgcn"])
def test_forward_dense_on_card_matches_cpu(dev, arch):
    cfg = get_config(arch)
    shp = shapes_for_family("gnn")["molecule"]
    params = gnn.init_params(cfg, torch.Generator().manual_seed(2),
                             shp.d_feat, shp.n_classes, "cpu")
    rng = np.random.default_rng(3)
    b, n = shp.batch_graphs, shp.nodes_per_graph
    adj = torch.from_numpy((rng.random((b, n, n)) < 0.2).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal(
        (b, n, shp.d_feat)).astype(np.float32))
    want = gnn.forward_dense(cfg, params, adj, feats)
    _lib.LAUNCHES.reset()
    card_params = {"layers": [{k: v.to(dev) for k, v in lp.items()}
                              for lp in params["layers"]],
                   "readout": params["readout"].to(dev),
                   "readout_b": params["readout_b"].to(dev)}
    got = gnn.forward_dense(cfg, card_params, adj.to(dev), feats.to(dev))
    _close(got, want, forward_tol(want))
    want_launches = 0 if cfg.conv == "gatedgcn" else cfg.n_layers
    assert _lib.LAUNCHES["batched_mp"] == want_launches


FLASH_SHAPES = [
    # (b, sq, sk, h, hd, causal, q_offset): the reference tests' sweep, the
    # short causal rows of S = 70, and a ragged continuation
    (1, 128, 128, 2, 64, True, 0), (2, 256, 256, 1, 128, True, 0),
    (1, 130, 190, 2, 64, True, 0), (1, 64, 512, 1, 64, False, 0),
    (2, 64, 256, 2, 64, True, 192), (1, 96, 96, 3, 128, False, 0),
    (1, 70, 70, 1, 64, True, 0), (1, 37, 300, 2, 128, True, 100)]


# (b, sq, sk, h, kv, hd, causal, q_offset): k and v grouped, read in place
# (llama3-8b's G 4 at hd 128, tinyllama's G 8 at hd 64, ragged G 2)
GQA_SHAPES = [
    (1, 1000, 1000, 32, 8, 128, True, 0), (2, 700, 700, 32, 4, 64, True, 0),
    (1, 300, 333, 4, 2, 64, False, 0), (1, 300, 333, 4, 2, 128, True, 50),
    (2, 130, 190, 8, 1, 64, True, 7)]


def _qkv(shape, dtype, seed=0, kv=None):
    b, sq, sk, h, hd = shape[:5]
    kv = kv or h
    rng = np.random.default_rng(seed + sq + sk)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype) for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


def _gqa(shape, dtype, seed=0):
    """(q, k, v) on the CPU and (causal, q_offset) for a GQA_SHAPES row."""
    b, sq, sk, h, kv, hd, causal, qo = shape
    return _qkv((b, sq, sk, h, hd), dtype, seed, kv=kv), causal, qo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GQA_SHAPES)
def test_flash_fwd_gqa_matches_plain(dev, dtype, shape):
    """Kernel 6 with k, v [B, Sk, KV, hd] read in place against the plain
    version (which expands them), out and lse; one launch."""
    (q, k, v), causal, qo = _gqa(shape, dtype)
    before = _lib.LAUNCHES["flash_fwd"]
    out, lse = flash_fwd(q.to(dev), k.to(dev), v.to(dev), causal=causal,
                         q_offset=qo)
    assert _lib.LAUNCHES["flash_fwd"] == before + 1
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=qo)
    _close(out.float(), want.float(), FLASH_TOL[dtype])
    _close(lse, want_lse, FLASH_TOL[dtype])


def test_flash_fwd_is_bit_reproducible(dev):
    """No atomics and a fixed order of sums: repeat runs of kernel 6 give
    the same bits, in both dtypes and both kernels."""
    for dtype in (torch.float32, torch.bfloat16):
        for shape in GQA_SHAPES[:2]:
            (q, k, v), causal, qo = _gqa(shape, dtype)
            q, k, v = q.to(dev), k.to(dev), v.to(dev)
            runs = [flash_fwd(q, k, v, causal=causal, q_offset=qo)
                    for _ in range(3)]
            for again in runs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


# (b, sq, sk, h, kv, hd, causal, q_offset) for kernels 7 and 8: G 1 (the
# forward's sweep, kv = h), then grouped k, v read in place at G 2, 4 and
# 8, hd 64 and 128, ragged and at an offset
BWD_SHAPES = ([(b, sq, sk, h, h, hd, c, qo)
               for b, sq, sk, h, hd, c, qo in FLASH_SHAPES] + GQA_SHAPES
              + [(1, 200, 260, 8, 1, 128, True, 3),
                 (1, 257, 257, 8, 2, 64, True, 0),
                 (2, 96, 160, 8, 2, 128, False, 0),
                 (1, 64, 300, 16, 2, 64, True, 236)])
BWD_IDS = ["-".join(map(str, s)) for s in BWD_SHAPES]
# G 1, 2, 4, 8 at hd 64 and 128 (G 8 at hd 128, G 1 at hd 64 from the
# sweep)
BWD_GROUPS = [BWD_SHAPES[i] for i in (0, 1, 8, 9, 10, 11, 13, 14)]


def _bwd_close(got, want, dtype, rows=True):
    """Kernels 7 and 8 against the plain version: float32 at 2e-4 (the
    reference's tolerance against its oracle); bfloat16 (both round P and
    dS to bfloat16) at rtol 3e-2 and an atol of 3e-2 times the largest
    magnitude in each row of head-dim values (one query row of dq, one key
    of dk or dv) plus 1e-5 of the tensor's largest. Under the causal mask
    the key gradients fall from the first keys to the last, so a limit
    taken over the whole tensor would let a fault confined to late key or
    query tiles pass. The floor covers rows that are 0 in exact arithmetic
    (query row 0 of a causal call at q_offset 0 sees one key, so dS = P·(dP
    - delta) cancels): they hold float32 rounding noise, well under the
    floor (chip_smoke.py prints it). With ``rows`` false, atol is 3e-2 of
    the tensor's largest magnitude: for gradients whose backward inputs
    differ (another forward's bf16 out), where a query row of two or
    three keys turns one bf16 ulp of out into a large share of its dS."""
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        _close(got, want, dict(rtol=2e-4, atol=2e-4))
        return
    mag = want.abs()
    if rows:
        limit = (3e-2 * (mag.amax(dim=-1, keepdim=True) + mag)
                 + 1e-5 * mag.max())
    else:
        limit = 3e-2 * (mag.max() + mag)
    bad = (got - want).abs() > limit
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} elements off, the first at "
        f"{tuple(bad.nonzero()[0].tolist())}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_GROUPS,
                         ids=[f"G{s[3] // s[4]}-hd{s[5]}" for s in BWD_GROUPS])
def test_flash_gqa_backward_on_card_matches_cpu(dev, dtype, shape):
    """The autograd backward on grouped k, v (kernels 7 and 8 read them in
    place, kernel 8 sums dk and dv over each group) on a card against the
    CPU's, at the backward's tolerances; in bf16 relative to each
    gradient's largest magnitude, since the card's forward rounds out
    otherwise than the CPU's (test_flash_bwd_matches_plain holds the
    kernels per row on the same inputs)."""
    (q, k, v), causal, qo = _gqa(shape, dtype)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    dout = dout.to(dtype)
    card = [t.to(dev).requires_grad_() for t in (q, k, v)]
    host = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(_lib.LAUNCHES)
    flash_attention(*card, causal=causal, q_offset=qo).backward(dout.to(dev))
    assert _lib.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _lib.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    flash_attention(*host, causal=causal, q_offset=qo).backward(dout)
    for c, h in zip(card, host):
        assert c.grad.shape == h.grad.shape and c.grad.dtype == dtype
        _bwd_close(c.grad, h.grad, dtype, rows=False)


def test_flash_backward_on_card_makes_no_kv_copy(dev, monkeypatch):
    """On a card the autograd backward hands grouped k, v to kernels 7 and
    8 as they are: no ``expand_kv`` and no ``repeat_interleave`` copy."""
    from repro_torch.kernels import flash_attention as fa

    def refuse(*args, **kw):
        raise AssertionError("the card's backward copied k or v")
    (q, k, v), causal, qo = _gqa(GQA_SHAPES[1], torch.bfloat16)
    card = [t.to(dev).requires_grad_() for t in (q, k, v)]
    out = flash_attention(*card, causal=causal, q_offset=qo)
    monkeypatch.setattr(fa, "expand_kv", refuse)
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", refuse)
    before = dict(_lib.LAUNCHES)
    out.backward(torch.ones_like(out))
    assert _lib.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _lib.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    assert card[1].grad.shape == k.shape and card[2].grad.shape == v.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_fwd_matches_plain(dev, dtype, shape):
    causal, qo = shape[5:]
    q, k, v = _qkv(shape, dtype)
    before = _lib.LAUNCHES["flash_fwd"]
    out, lse = flash_fwd(q.to(dev), k.to(dev), v.to(dev), causal=causal,
                         q_offset=qo)
    assert _lib.LAUNCHES["flash_fwd"] == before + 1
    assert out.dtype == dtype and lse.shape == (shape[0], shape[3], shape[1])
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=qo)
    _close(out.float(), want.float(), FLASH_TOL[dtype])
    _close(lse, want_lse, FLASH_TOL[dtype])


def _bwd_inputs(shape, dtype, dev):
    """(q, k, v, out, lse, dout) on ``dev`` for a BWD_SHAPES row, out and
    lse from kernel 6."""
    b, sq, sk, h, kv, hd, causal, qo = shape
    q, k, v = (t.to(dev) for t in _qkv((b, sq, sk, h, hd), dtype, kv=kv))
    g = torch.Generator().manual_seed(b + sq + sk + h + hd)
    dout = torch.randn(q.shape, generator=g).to(dtype).to(dev)
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=BWD_IDS)
def test_flash_bwd_matches_plain(dev, dtype, shape):
    """Kernels 7 and 8 on k, v [B, Sk, KV, hd] (G 1, 2, 4, 8; hd 64, 128)
    against flash_bwd_plain: float32 at 2e-4 (the reference's tolerance
    against its oracle), bfloat16 at 3e-2 of the largest magnitude in each
    row (``_bwd_close``); one launch each."""
    causal, qo = shape[6:]
    args = _bwd_inputs(shape, dtype, dev)
    q, k, v, out, lse, dout = args
    delta = row_delta(out, dout)
    before = dict(_lib.LAUNCHES)
    got = (flash_bwd_dq(q, k, v, dout, lse, delta, causal=causal,
                        q_offset=qo),
           *flash_bwd_dkv(q, k, v, dout, lse, delta, causal=causal,
                          q_offset=qo))
    assert _lib.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _lib.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = flash_bwd_plain(*(t.cpu() for t in args), causal=causal,
                           q_offset=qo)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _bwd_close(g, w, dtype)


def test_flash_bwd_is_bit_reproducible(dev):
    """No atomics and a fixed order of the group's heads: repeat runs give
    the same bits, at G 1, 2, 4, 8, hd 64 and 128, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(2, 256, 300, 4, 4, 64, True, 44)] + BWD_GROUPS:
            causal, qo = shape[6:]
            q, k, v, out, lse, dout = _bwd_inputs(shape, dtype, dev)
            runs = [flash_bwd(q, k, v, out, lse, dout, causal=causal,
                              q_offset=qo) for _ in range(3)]
            for again in runs[1:]:
                for a, b in zip(runs[0], again):
                    assert torch.equal(a, b)


def test_flash_backward_on_card_launches_kernels(dev):
    """The autograd backward of flash_attention on a card is kernels 7 and
    8, and matches the CPU's backward (flash_bwd_plain)."""
    shape = FLASH_SHAPES[2]
    q, k, v = _qkv(shape, torch.float32)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    card = [t.to(dev).requires_grad_() for t in (q, k, v)]
    host = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(_lib.LAUNCHES)
    flash_attention(*card).backward(dout.to(dev))
    assert _lib.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _lib.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    flash_attention(*host).backward(dout)
    for c, h in zip(card, host):
        _close(c.grad, h.grad, dict(rtol=2e-4, atol=2e-4))


def test_flash_bwd_refuses_bad_operands(dev):
    q, k, v, out, lse, dout = _bwd_inputs(BWD_SHAPES[0], torch.float32, dev)
    delta = row_delta(out, dout)
    small = [t[..., :32].contiguous() for t in (q, k, v, dout)]
    with pytest.raises(ValueError, match="hd in"):
        flash_bwd_dq(*small[:3], small[3], lse, delta)
    with pytest.raises(ValueError, match="hd in"):
        flash_bwd_dkv(*small[:3], small[3], lse, delta)
    with pytest.raises(TypeError):
        flash_bwd_dq(q, k.bfloat16(), v, dout, lse, delta)
    with pytest.raises(TypeError, match="dout"):
        flash_bwd_dkv(q, k, v, dout.bfloat16(), lse, delta)
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd_dq(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                     dout, lse, delta)
    three = torch.cat([k, k[:, :, :1]], dim=2)       # 3 kv heads, H = 2
    with pytest.raises(ValueError, match="GQA"):
        flash_bwd_dkv(q, three, three, dout, lse, delta)


def _to(tree, dev):
    """A copy of a nested dict of tensors on ``dev`` (the host step count
    stays on the host)."""
    if isinstance(tree, dict):
        return {k: (v.clone() if k == "step" else _to(v, dev))
                for k, v in tree.items()}
    return tree.to(dev)


def _train_smoke_hd64():
    """tinyllama-1.1b's SMOKE config at head dim 64 (SMOKE's own is 16),
    4 microbatches, remat."""
    return dataclasses.replace(get_smoke("tinyllama-1.1b"), head_dim=64,
                               remat=True)


def test_lm_train_cell_on_card_matches_cpu(dev):
    """Two steps of the train cell: card vs CPU on the same state, with
    kernel 6 twice per layer and microbatch (remat) and kernels 7 and 8
    once."""
    cfg = _train_smoke_hd64()
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=8,
                              seq_len=96)
    cells = {d: api.build_cell(cfg, "train_4k", device=d, shape_override=shp)
             for d in ("cpu", dev)}
    host = api.materialize_state(cells["cpu"], cfg, "train_4k",
                                 torch.Generator().manual_seed(4))
    card = _to(host, dev)
    rng = np.random.default_rng(5)
    L, mb = cfg.n_layers, cfg.microbatches
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 96)).astype(
            np.int32))
        labs = torch.roll(toks, -1, dims=1)
        _lib.LAUNCHES.reset()
        card, got = cells[dev].step(card, {"tokens": toks.to(dev),
                                           "labels": labs.to(dev)})
        assert _lib.LAUNCHES["flash_fwd"] == 2 * L * mb
        assert _lib.LAUNCHES["flash_bwd_dq"] == L * mb
        assert _lib.LAUNCHES["flash_bwd_dkv"] == L * mb
        host, want = cells["cpu"].step(host, {"tokens": toks,
                                              "labels": labs})
        for key in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(got[key].cpu().float(),
                                       want[key].float(), rtol=1e-4, atol=0)
        lr = float(want["lr"])
        for name, t in card["params"]["layers"].items():
            _close(t, host["params"]["layers"][name],
                   dict(rtol=0, atol=2 * lr))
            _close(card["opt"]["v"]["layers"][name],
                   host["opt"]["v"]["layers"][name],
                   forward_tol(host["opt"]["v"]["layers"][name]))


def test_trainer_full_config_on_card(dev):
    """tinyllama-1.1b at its published widths and depth, two short steps
    through the Trainer."""
    from repro_torch.launch.train import Trainer
    tr = Trainer("tinyllama-1.1b", batch_override=4, seq_override=256)
    assert tr.cfg == get_config("tinyllama-1.1b")
    _lib.LAUNCHES.reset()
    hist = tr.run(2)
    L, mb = tr.cfg.n_layers, tr.cfg.microbatches
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert _lib.LAUNCHES["flash_fwd"] == 2 * 2 * L * mb
    assert _lib.LAUNCHES["flash_bwd_dq"] == 2 * L * mb
    assert _lib.LAUNCHES["flash_bwd_dkv"] == 2 * L * mb


def test_flash_refuses_bad_operands(dev):
    q, k, v = (t.to(dev) for t in _qkv(FLASH_SHAPES[0], torch.float32))
    with pytest.raises(ValueError, match="hd in"):
        flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                  v[..., :32].contiguous())
    with pytest.raises(TypeError):
        flash_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_fwd(q.half(), k.half(), v.half())
    three = torch.cat([k, k[:, :, :1]], dim=2)      # 3 kv heads, H = 2
    with pytest.raises(ValueError, match="GQA"):
        flash_fwd(q, three, three)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)


def test_decode_attention_bf16_on_card_matches_cpu(dev):
    """The card's bfloat16 decode takes its scores in float32, as the CPU
    path (and the reference) do: at scores of ~±100 a bfloat16 rounding
    of them would miss this tolerance by far."""
    from repro_torch.models.attention import decode_attention
    g = torch.Generator().manual_seed(8)
    q = (8 * torch.randn(2, 1, 32, 128, generator=g)).bfloat16()
    k, v = (torch.randn(2, 1000, 8, 128, generator=g).bfloat16()
            for _ in range(2))
    want = decode_attention(q, k, v, 900).float()
    got = decode_attention(q.to(dev), k.to(dev), v.to(dev), 900)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float().cpu(), want, rtol=1e-2,
                               atol=1e-2 * float(want.abs().max()))


def _lm_smoke_hd64():
    """llama3-8b's SMOKE config at head dim 64: SMOKE's own hd of 32 is
    below the kernel's."""
    return dataclasses.replace(get_smoke("llama3-8b"), head_dim=64)


def test_lm_prefill_and_decode_on_card_match_cpu(dev):
    cfg = _lm_smoke_hd64()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(5),
                                     "cpu")
    card = {"embed": params["embed"].to(dev),
            "final_norm": params["final_norm"].to(dev),
            "lm_head": params["lm_head"].to(dev),
            "layers": {k: v.to(dev) for k, v in params["layers"].items()}}
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 100)).astype(np.int32))
    want, cache = transformer.prefill(cfg, params, toks, 104)
    _lib.LAUNCHES.reset()
    got, card_cache = transformer.prefill(cfg, card, toks.to(dev), 104)
    assert _lib.LAUNCHES["flash_fwd"] == cfg.n_layers
    _close(got, want, forward_tol(want))
    _close(card_cache["k"], cache["k"], forward_tol(cache["k"]))
    for i in range(3):
        nxt = want.argmax(-1, keepdim=True).to(torch.int32)
        want, cache = transformer.decode_step(cfg, params, cache, nxt,
                                              100 + i)
        got, card_cache = transformer.decode_step(cfg, card, card_cache,
                                                  nxt.to(dev), 100 + i)
        _close(got, want, forward_tol(want))
    _close(card_cache["v"], cache["v"], forward_tol(cache["v"]))
    assert _lib.LAUNCHES["flash_fwd"] == cfg.n_layers   # none in decode


def test_serve_lm_full_config_on_card(dev):
    _lib.LAUNCHES.reset()
    res = serve.serve_lm("tinyllama-1.1b", 2, 256, 4)
    cfg = get_config("tinyllama-1.1b")
    assert res["tokens"].shape == (2, 4)
    assert _lib.LAUNCHES["flash_fwd"] == cfg.n_layers


# ------------------------------------------------ MoE LMs, int8 KV cache --
def _moe_smoke_hd64(arch="moonshot-v1-16b-a3b"):
    """An MoE arch's SMOKE config at head dim 64 (kernel 6's smallest)."""
    return dataclasses.replace(get_smoke(arch), head_dim=64)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch,dtype,b,s", [
    ("moonshot-v1-16b-a3b", torch.float32, 4, 300),
    ("phi3.5-moe-42b-a6.6b", torch.float32, 1, 1),
    ("moonshot-v1-16b-a3b", torch.bfloat16, 2, 256)])
def test_moe_ffn_on_card_matches_cpu(dev, arch, dtype, b, s):
    """The MoE FFN on the card against the CPU on the same inputs: the
    same route and [E, C] tables, the output within rounding."""
    cfg = dataclasses.replace(get_smoke(arch),
                              dtype=str(dtype).split(".")[-1])
    lp = {k: v[0] for k, v in transformer.init_params(
        cfg, torch.Generator().manual_seed(2), "cpu")["layers"].items()}
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3)).to(dtype)
    xf = x.reshape(b * s, -1)
    C = transformer.capacity(cfg.moe, b * s)
    tables = []
    for where, lay, xx in (("cpu", lp, xf), ("card", _to(lp, dev),
                                             xf.to(dev))):
        gates, experts = transformer.route(cfg.moe, lay["router"], xx)
        tables.append((experts.cpu(), *(t.cpu() for t in
                       transformer.dispatch_tables(gates, experts,
                                                   cfg.moe.n_experts, C))))
    for got, want in zip(tables[1], tables[0]):
        if got.dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got, want)
    want = transformer._moe_ffn(cfg, lp, x)
    got = transformer._moe_ffn(cfg, _to(lp, dev), x.to(dev))
    assert got.is_cuda and got.dtype == dtype
    tol = (forward_tol(want) if dtype == torch.float32 else dict(
        rtol=2e-2, atol=2e-2 * float(want.float().abs().max())))
    _close(got.float(), want.float(), tol)


def test_moe_route_ties_lower_index_first_on_card(dev):
    """Equal probabilities on the card: the K experts are the lowest
    indices (a stable sort, as ``jax.lax.top_k`` orders ties), and the
    queue positions are the tokens' order, at moonshot's E 64, K 6."""
    from repro_torch.configs.base import MoESpec
    moe = MoESpec(n_experts=64, top_k=6)
    G, D = 4096, 256
    xf = torch.randn(G, D, device=dev)
    gates, experts = transformer.route(
        moe, torch.zeros(D, 64, device=dev), xf)
    assert torch.equal(experts.cpu(), torch.arange(6).expand(G, 6))
    pos = transformer.queue_positions(experts.reshape(-1), 64).cpu()
    assert torch.equal(pos, torch.arange(G).repeat_interleave(6))
    # ties among some experts only: two equal router columns
    router = torch.randn(D, 64, device=dev)
    router[:, 9] = router[:, 3]
    _, e = transformer.route(moe, router, xf)
    _, e_cpu = transformer.route(moe, router.cpu(), xf.cpu())
    both = (e == 3).any(-1) & (e == 9).any(-1)
    assert bool(both.any())
    k3 = (e == 3).int().argmax(-1)
    k9 = (e == 9).int().argmax(-1)
    assert bool((k3[both] < k9[both]).all())
    assert torch.equal(e.cpu(), e_cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_attention_on_card_matches_cpu(dev, dtype):
    from repro_torch.models.attention import decode_attention
    g = torch.Generator().manual_seed(9)
    q = torch.randn(2, 1, 32, 128, generator=g).to(dtype)
    k, v = (torch.randn(1, 2, 1000, 8, 128, generator=g) for _ in range(2))
    cache = transformer.quantize_cache({"k": k, "v": v})
    args = (cache["k"][0], cache["v"][0])
    scales = dict(k_scale=cache["k_scale"][0], v_scale=cache["v_scale"][0])
    want = decode_attention(q, *args, 900, **scales)
    got = decode_attention(q.to(dev), *(a.to(dev) for a in args), 900,
                           **{n: t.to(dev) for n, t in scales.items()})
    assert got.dtype == dtype == want.dtype
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else
           dict(rtol=1e-2, atol=1e-2 * float(want.float().abs().max())))
    torch.testing.assert_close(got.float().cpu(), want.float(), **tol)
    card = transformer.quantize_cache({"k": k.to(dev), "v": v.to(dev)})
    for name, t in cache.items():
        assert torch.equal(card[name].cpu(), t), name


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_generate_on_card_matches_cpu(dev, arch):
    """A SMOKE MoE arch (head dim 64) through ``generate``: prefill with
    kernel 6 once a layer, the cache re-encoded to int8, greedy decode;
    the card's tokens are the CPU's."""
    cfg = _moe_smoke_hd64(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(5),
                                     "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 100)).astype(np.int32))
    want = serve.generate(cfg, params, toks, 9)
    _lib.LAUNCHES.reset()
    got = serve.generate(cfg, _to(params, dev), toks.to(dev), 9)
    assert _lib.LAUNCHES["flash_fwd"] == cfg.n_layers
    assert torch.equal(got["tokens"], want["tokens"])


# ------------------------------------------------ GNN and recsys training --
@pytest.mark.parametrize("b,n,f,h", [(128, 30, 16, 64), (128, 30, 64, 64),
                                     (65, 30, 70, 70), (4, 100, 64, 64),
                                     (2, 40, 64, 200)])
def test_batched_mp_backward_matches_plain(dev, b, n, f, h):
    """BatchedMP's dx, dw (kernel 9 on adjᵀ, dy, I_H, then two GEMMs)
    against autograd of the plain einsums on the same card tensors."""
    from repro_torch.kernels.batched_mp import BatchedMP
    rng = np.random.default_rng(b + n + f + h)
    adj = torch.from_numpy((rng.random((b, n, n)) < 0.2).astype(
        np.float32)).to(dev)
    x0 = torch.from_numpy(rng.standard_normal((b, n, f)).astype(
        np.float32)).to(dev)
    w0 = torch.from_numpy(rng.standard_normal((f, h)).astype(
        np.float32)).to(dev)
    dy = torch.from_numpy(rng.standard_normal((b, n, h)).astype(
        np.float32)).to(dev)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    _lib.LAUNCHES.reset()
    dx, dw = torch.autograd.grad(BatchedMP.apply(adj, x, w), (x, w), dy)
    assert _lib.LAUNCHES["batched_mp"] == 1
    assert _lib.LAUNCHES["batched_mp_bwd"] == 1
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    dxr, dwr = torch.autograd.grad(batched_mp_plain(adj, xr, wr), (xr, wr),
                                   dy)
    for got, want in ((dx, dxr), (dw, dwr)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def _card_state(state, dev):
    if isinstance(state, dict):
        return {k: _card_state(v, dev) for k, v in state.items()}
    if isinstance(state, list):
        return [_card_state(v, dev) for v in state]
    # AdamW's step count stays on the host
    return state if state.dim() == 0 and state.dtype == torch.int32 \
        else state.to(dev)


def _state_close(got, want, lr):
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    for (path, g), (_, w) in zip(_flatten_with_paths(got),
                                 _flatten_with_paths(want)):
        g = g.cpu()
        if path.startswith("params/"):     # an update may flip near 0
            torch.testing.assert_close(g, w, rtol=0, atol=2 * lr, msg=path)
        else:
            torch.testing.assert_close(g, w, **forward_tol(w), msg=path)


def _two_steps_card_vs_cpu(dev, cfg, shape_name, shp, batches):
    cpu = api.build_cell(cfg, shape_name, device="cpu", shape_override=shp)
    card = api.build_cell(cfg, shape_name, shape_override=shp)
    host = api.materialize_state(cpu, cfg, shape_name,
                                 torch.Generator().manual_seed(0))
    on_card = _card_state(host, dev)
    host = _card_state(on_card, "cpu")          # a copy, not the same tensors
    for batch in batches:
        host, want = cpu.step(host, batch)
        on_card, got = card.step(on_card, {k: v.to(dev)
                                           for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4,
                                       atol=0)
        _state_close(on_card, host, float(want["lr"]))


def test_gin_molecule_train_step_on_card_matches_cpu(dev):
    cfg = get_config("gin-tu")
    shp = shapes_for_family("gnn")["molecule"]
    rng = np.random.default_rng(5)
    b, n = shp.batch_graphs, shp.nodes_per_graph
    batches = [{"adj": torch.from_numpy((rng.random((b, n, n)) < 0.2).astype(
                    np.float32)),
                "feats": torch.from_numpy(rng.standard_normal(
                    (b, n, shp.d_feat)).astype(np.float32)),
                "labels": torch.from_numpy(rng.integers(
                    0, shp.n_classes, b).astype(np.int32))}
               for _ in range(2)]
    _lib.LAUNCHES.reset()
    _two_steps_card_vs_cpu(dev, cfg, "molecule", shp, batches)
    # kernel 9 forward once a layer a step, and backward once a layer but
    # the first (its x, the features, and w, I_F, take no gradient)
    assert _lib.LAUNCHES["batched_mp"] == 2 * cfg.n_layers
    assert _lib.LAUNCHES["batched_mp_bwd"] == 2 * (cfg.n_layers - 1)


def test_mind_train_step_on_card_matches_cpu(dev):
    cfg = get_smoke("mind")
    shp = dataclasses.replace(shapes_for_family("recsys")["train_batch"],
                              batch=256)
    rng = np.random.default_rng(6)
    L, B = cfg.hist_len, shp.batch
    batches = [{"hist_ids": torch.from_numpy(rng.integers(
                    0, cfg.n_items, (B, L)).astype(np.int32)),
                "hist_mask": torch.from_numpy((rng.random((B, L)) < 0.9)
                                              .astype(np.float32)),
                "target": torch.from_numpy(rng.integers(
                    0, cfg.n_items, B).astype(np.int32)),
                "negatives": torch.from_numpy(rng.integers(
                    0, cfg.n_items, (B, cfg.n_negatives)).astype(np.int32))}
               for _ in range(2)]
    _two_steps_card_vs_cpu(dev, cfg, "train_batch", shp, batches)


def test_trainer_recovery_on_card_bit_for_bit(dev, tmp_path):
    """tinyllama's widths cut to 2 layers in float32: a worker failure at
    step 5 rolls back to step 4's checkpoint, and the run ends with the
    losses and params of an uninterrupted run, bit for bit."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.launch.train import Trainer
    from repro_torch.runtime.fault_tolerance import FaultInjector
    cut = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2,
                              dtype="float32", microbatches=2)
    runs = []
    for name, inj in (("clean", None),
                      ("failed", FaultInjector.worker_failure_at(step=5))):
        tr = Trainer("tinyllama-1.1b", cfg_override=cut, batch_override=2,
                     seq_override=256, ckpt_dir=str(tmp_path / name),
                     fault_injector=inj, device=dev)
        tr.restore_or_init()
        hist = tr.run(6, ckpt_every=2, log_every=100)
        runs.append((tr, {h["step"]: h["loss"] for h in hist}))
    (clean, want), (failed, got) = runs
    assert failed.recoveries == 1 and got == want
    for (path, a), (_, b) in zip(_flatten_with_paths(failed.state),
                                 _flatten_with_paths(clean.state)):
        assert torch.equal(a, b), path


# ------------------------------------------- MoE training, expert parallel --
def _moe_train_smoke(arch="moonshot-v1-16b-a3b", dtype="float32"):
    """An MoE arch's SMOKE config at head dim 64 with its published MoE
    spec (moonshot: 64 experts top 6), remat and 2 microbatches."""
    return dataclasses.replace(get_smoke(arch), head_dim=64, remat=True,
                               microbatches=2, dtype=dtype,
                               moe=get_config(arch).moe)


def _moe_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32))
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_train_cell_on_card_matches_cpu(dev, arch):
    """One MoE train step, card vs CPU on the same state: the loss at
    rtol 1e-5, m (every leaf's gradient) and v at rtol 1e-4 and atol 5e-4
    × max|want|, params at atol 2·lr; kernel 6 twice per layer and
    microbatch (remat), kernels 7 and 8 once."""
    cfg = _moe_train_smoke(arch)
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=4,
                              seq_len=128)
    cells = {d: api.build_cell(cfg, "train_4k", device=d, shape_override=shp)
             for d in ("cpu", dev)}
    host = api.materialize_state(cells["cpu"], cfg, "train_4k",
                                 torch.Generator().manual_seed(6))
    card = _to(host, dev)
    batch = _moe_batch(cfg, 4, 128, 7)
    _lib.LAUNCHES.reset()
    card, got = cells[dev].step(card, {k: v.to(dev) for k, v in
                                       batch.items()})
    L, mb = cfg.n_layers, cfg.microbatches
    assert _lib.LAUNCHES["flash_fwd"] == 2 * L * mb
    assert _lib.LAUNCHES["flash_bwd_dq"] == _lib.LAUNCHES[
        "flash_bwd_dkv"] == L * mb
    host, want = cells["cpu"].step(host, batch)
    torch.testing.assert_close(got["loss"].cpu(), want["loss"], rtol=1e-5,
                               atol=0)
    lr = float(want["lr"])
    for name, t in card["params"]["layers"].items():
        _close(t, host["params"]["layers"][name], dict(rtol=0, atol=2 * lr))
        for mv in ("m", "v"):
            w = host["opt"][mv]["layers"][name]
            _close(card["opt"][mv]["layers"][name], w,
                   dict(rtol=1e-4, atol=5e-4 * float(w.abs().max())))


def test_moe_train_step_same_bits_on_every_run_on_card(dev):
    """The combine sums each token's K slots in a fixed order (no
    atomics): two bf16 train steps from one state give the same bits,
    at moonshot's 64 experts top 6."""
    cfg = _moe_train_smoke(dtype="bfloat16")
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=4,
                              seq_len=256)
    cell = api.build_cell(cfg, "train_4k", device=dev, shape_override=shp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    first = api.materialize_state(cell, cfg, "train_4k", gen)
    second = _to(first, "cpu")
    second = _to(second, dev)
    batch = {k: v.to(dev) for k, v in _moe_batch(cfg, 4, 256, 9).items()}
    first, m1 = cell.step(first, batch)
    second, m2 = cell.step(second, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for name, t in first["params"]["layers"].items():
        assert torch.equal(t, second["params"]["layers"][name]), name


def test_moe_expert_parallel_world_one_nccl(dev, tmp_path):
    """A world-1 NCCL group (mesh 1x1): the expert-parallel FFN holds every
    expert and equals the gather path bit for bit; the train cell built
    with the mesh steps as the one without, launching no collective."""
    import torch.distributed as dist

    from repro_torch.core.distributed import ServingMesh
    from repro_torch.parallel import CALLS
    cfg = _moe_train_smoke(dtype="bfloat16")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        mesh = ServingMesh("sharded", (1, 1))
        CALLS.clear()
        lp = {k: v[0] for k, v in transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(3), dev)[
                "layers"].items()}
        x = torch.randn(2, 256, cfg.d_model, device=dev).bfloat16()
        got = transformer._moe_ffn(cfg, lp, x, transformer.ExpertMesh(mesh))
        assert torch.equal(got, transformer._moe_ffn(cfg, lp, x))
        shp = dataclasses.replace(shapes_for_family("lm")["train_4k"],
                                  batch=4, seq_len=128)
        cells = [api.build_cell(cfg, "train_4k", mesh=mesh,
                                shape_override=shp),
                 api.build_cell(cfg, "train_4k", device=dev,
                                shape_override=shp)]
        assert cells[0].device.type == "cuda"
        state = api.materialize_state(cells[0], cfg, "train_4k",
                                      torch.Generator(device=dev)
                                      .manual_seed(4))
        states = [state, _to(_to(state, "cpu"), dev)]
        batch = {k: v.to(dev) for k, v in _moe_batch(cfg, 4, 128, 5).items()}
        (s0, m0), (s1, m1) = (c.step(s, batch) for c, s in zip(cells,
                                                               states))
        assert torch.equal(m0["loss"], m1["loss"])
        torch.testing.assert_close(m0["grad_norm"], m1["grad_norm"],
                                   rtol=1e-5, atol=0)
        lr = float(m1["lr"])
        for name, t in s0["params"]["layers"].items():
            _close(t.float(), s1["params"]["layers"][name].float(),
                   dict(rtol=0, atol=2 * lr))
        assert sum(CALLS.values()) == 0
    finally:
        dist.destroy_process_group()


def test_dense_mesh_train_step_world_one_nccl_bit_for_bit(dev, tmp_path):
    """A world-1 NCCL group (mesh 1x1, ``make_debug_mesh``): the dense
    train cell built with the mesh (tensor parallelism and ZeRO-1 of one
    rank) steps as the one without, bit for bit, launching no
    collective."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.optimizer import _leaves
    from repro_torch.parallel import CALLS
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), head_dim=64,
                              dtype="bfloat16", remat=True, microbatches=2)
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=4,
                              seq_len=256)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        mesh = make_debug_mesh(device=dev)
        cells = [api.build_cell(cfg, "train_4k", mesh=mesh,
                                shape_override=shp),
                 api.build_cell(cfg, "train_4k", device=dev,
                                shape_override=shp)]
        states = [api.materialize_state(c, cfg, "train_4k",
                                        torch.Generator(device=dev)
                                        .manual_seed(4)) for c in cells]
        g = torch.Generator(device=dev).manual_seed(5)
        toks = torch.randint(0, cfg.vocab, (4, 256), generator=g, device=dev,
                             dtype=torch.int32)
        CALLS.clear()
        for _ in range(2):
            out = [c.step(s, {"tokens": toks, "labels": toks})
                   for c, s in zip(cells, states)]
            states = [o[0] for o in out]
            assert torch.equal(out[0][1]["loss"], out[1][1]["loss"])
            assert torch.equal(out[0][1]["grad_norm"], out[1][1]["grad_norm"])
        for a, b in zip(_leaves(states[0]), _leaves(states[1])):
            assert torch.equal(a, b)
        assert sum(CALLS.values()) == 0
    finally:
        dist.destroy_process_group()


def test_compression_on_the_card_equals_the_cpu(dev, tmp_path):
    """``quantize_int8`` of CUDA tensors, error feedback and the compressed
    sum (a world-1 NCCL group) give the CPU's bits: the divisions are
    true divisions on tensors on both."""
    import torch.distributed as dist

    from repro_torch.optim import compression as comp
    g = torch.Generator().manual_seed(6)
    xs = [torch.randn(1 << 16, generator=g),
          torch.randn((33, 129), generator=g) * 1e3,
          (torch.arange(-8, 9, dtype=torch.float32) + 0.5) / 127.0 * 8.5]
    for x in xs:
        q, s = comp.quantize_int8(x.to(dev))
        q_h, s_h = comp.quantize_int8(x)
        assert torch.equal(q.cpu(), q_h) and torch.equal(s.cpu(), s_h)
    grads = {"w": xs[0]}
    err_d = comp.init_error_state({"w": xs[0].to(dev)})
    err_h = comp.init_error_state(grads)
    for _ in range(5):
        d_d, err_d = comp.compress_with_feedback({"w": xs[0].to(dev)}, err_d)
        d_h, err_h = comp.compress_with_feedback(grads, err_h)
        assert torch.equal(d_d["w"].cpu(), d_h["w"])
        assert torch.equal(err_d["w"].cpu(), err_h["w"])
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        from repro_torch.launch.mesh import Mesh
        mesh = Mesh((1,), ("data",), device=dev)
        got = comp.compressed_psum(xs[1].to(dev), mesh.group("data"))
        assert torch.equal(got.cpu(), comp.compressed_psum(xs[1], None))
    finally:
        dist.destroy_process_group()


def _world_one_cells(cfg, name, shp, dev, batch, steps=1):
    """The cell on a world-1 mesh, and twice without one, from the same
    drawn state and batch: every output and leaf of each, ``steps``
    steps."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.optimizer import _leaves
    mesh = make_debug_mesh(device=dev)
    runs = []
    for m in (mesh, None, None):
        cell = api.build_cell(cfg, name, device=dev, mesh=m,
                              shape_override=shp)
        state = api.materialize_state(cell, cfg, name, torch.Generator(
            device=dev).manual_seed(6))
        outs = []
        for _ in range(steps):
            state, out = cell.step(state, batch)
            outs.append(out)
        runs.append(list(_leaves(state)) + list(_leaves(outs)))
    return runs


@pytest.mark.parametrize("arch,name,shape", [
    ("llama3-8b", "prefill_32k", dict(batch=1, seq_len=512)),
    ("llama3-8b", "decode_32k", dict(batch=2, seq_len=512)),
    ("moonshot-v1-16b-a3b", "prefill_32k", dict(batch=1, seq_len=256)),
    ("moonshot-v1-16b-a3b", "decode_32k", dict(batch=2, seq_len=256)),
    ("moonshot-v1-16b-a3b", "train_4k", dict(batch=4, seq_len=128)),
    ("gin-tu", "molecule", dict(batch_graphs=256)),
    ("graphsage-reddit", "ogb_products", dict(n_nodes=4000, n_edges=20000)),
    ("graphsage-reddit", "minibatch_lg", dict(batch_nodes=64)),
    ("mind", "train_batch", dict(batch=256)),
    ("mind", "serve_p99", {}),
    ("mind", "retrieval_cand", dict(n_candidates=100_000))])
def test_sharded_cells_world_one_nccl_bit_for_bit(dev, tmp_path, arch, name,
                                                  shape):
    """A world-1 NCCL group (mesh 1x1): each cell kind that took a mesh in
    this slice (SMOKE widths for the LMs, at head dim 64 for kernel 6)
    steps as the same cell without one, bit for bit, with no collective;
    where two runs without a mesh differ (float sums by atomics:
    ``index_add_`` in the segment sums and the table's gather backward),
    within the model outputs' tolerance of it."""
    import torch.distributed as dist

    from repro_torch.parallel import CALLS
    cfg = get_smoke(arch)
    if cfg.family == "lm":
        cfg = dataclasses.replace(cfg, head_dim=64, dtype="bfloat16",
                                  microbatches=2)
    shp = dataclasses.replace(shapes_for_family(cfg.family)[name], **shape)
    one = api.build_cell(cfg, name, device=dev, shape_override=shp)
    g = torch.Generator(device=dev).manual_seed(7)
    batch = {}
    for k, (s, dt) in one.batch_shapes.items():
        if k == "pos":
            batch[k] = torch.tensor(3, dtype=dt)
        elif dt == torch.int32:
            if cfg.family in ("lm", "recsys"):
                top = cfg.vocab if cfg.family == "lm" else cfg.n_items
            elif k == "labels":
                top = shp.n_classes
            else:                            # edge endpoints
                top = one.batch_shapes["feats"][0][0]
            batch[k] = torch.randint(0, top, s, generator=g, device=dev,
                                     dtype=dt)
        elif k == "adj":
            batch[k] = (torch.rand(s, generator=g, device=dev) < 0.2).float()
        elif k == "hist_mask":
            batch[k] = torch.ones(s, device=dev)
        else:
            batch[k] = torch.randn(s, generator=g, device=dev)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        CALLS.clear()
        a, b, c = _world_one_cells(cfg, name, shp, dev, batch,
                                   steps=2 if name == "decode_32k" else 1)
        assert len(a) == len(b) == len(c)
        repeats = all(torch.equal(y, z) for y, z in zip(b, c))
        for x, y in zip(a, b):
            if repeats:
                assert torch.equal(x, y)
            else:
                _close(x.float(), y.float(), forward_tol(y.float()))
        assert sum(CALLS.values()) == 0
    finally:
        dist.destroy_process_group()


def test_retrieval_score_on_a_rank_block_matches_plain(dev):
    """Kernel 10 on a data rank's block of MIND's retrieval_cand
    candidates (half of 1,000,448 at 2x1) against its plain version."""
    from repro_torch.models import recsys
    cfg = get_smoke("mind")
    g = torch.Generator(device=dev).manual_seed(8)
    table = torch.randn((cfg.n_items, cfg.embed_dim), generator=g,
                        device=dev)
    ids = torch.randint(0, cfg.n_items, (1_000_448,), generator=g,
                        device=dev, dtype=torch.int32)
    block = ids[500_224:]                 # data rank 1's candidates
    caps = torch.randn((cfg.n_interests, cfg.embed_dim), generator=g,
                       device=dev)
    cand = recsys.lookup(table, block)
    _close(retrieval_score(cand, caps), retrieval_score_plain(cand, caps),
           KERNEL_TOL)
