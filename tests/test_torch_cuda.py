"""The port's CUDA kernels against their plain PyTorch versions, and the
engine, the recsys cells, the GNN forward, the LM's prefill and decode and
the LM train cell on the card against the same on the CPU. Needs a CUDA device:
every test here carries the ``cuda`` marker and skips without one. The
file imports neither JAX nor the reference package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
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


@pytest.mark.parametrize("k", [1, 8, 32])
def test_stab_packed_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    meta, slab = _packed(rng, 5000, k)
    cs, ct = _pairs(rng, 5000, 70_001)
    args = [_i32(a) for a in (meta, slab, cs, ct)]
    before = _lib.LAUNCHES["stab_packed"]
    _same(stab_packed(*(a.to(dev) for a in args)), stab_packed_plain(*args))
    assert _lib.LAUNCHES["stab_packed"] == before + 1


@pytest.mark.parametrize("k,w", [(1, 2), (8, 2), (32, 1), (3, 0)])
def test_stab_naive_matches_plain(dev, k, w):
    rng = np.random.default_rng(k + w)
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
    cs, ct = (_i32(a) for a in _pairs(rng, n, 50_000))
    _same(stab_naive(*(t.to(dev) for t in tables), cs.to(dev), ct.to(dev)),
          stab_naive_plain(*tables, cs, ct))


def test_probe_matches_plain(dev):
    rng = np.random.default_rng(1)
    q, n, c = 256, 1 << 20, 1 << 20
    args = [_i32(a) for a in (
        rng.integers(0, q, c), rng.integers(0, n, c), rng.random(c) < 0.8,
        rng.integers(0, 2**32, (q, n // 32), dtype=np.uint32),
        rng.random(q) < 0.2)]
    _same(ff.probe(*(a.to(dev) for a in args), 20),
          ff.probe_plain(*args, 20))


@pytest.mark.parametrize("k", [1, 8])
def test_classify_emit_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    meta, slab = _packed(rng, 4000, k)
    cs, ct = _pairs(rng, 4000, 50_000)
    keys = rng.integers(0, 2**30, cs.size)
    keys[::5] = SENTINEL
    args = [_i32(a) for a in (meta[cs], meta[ct], slab[cs], keys, cs == ct)]
    _same(ff.classify_emit(*(a.to(dev) for a in args)),
          ff.classify_emit_plain(*args))


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
                                       (33, 3, 32)])
def test_merge_cover_matches_plain(dev, m, k, w_out):
    rng = np.random.default_rng(m + k)
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
    (2, 1024, 64, 64)])
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
