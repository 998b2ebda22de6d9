"""The port's CUDA kernels against their plain PyTorch versions, and the
engine on the card against the engine on the CPU. Needs a CUDA device:
every test here carries the ``cuda`` marker and skips without one. The
file imports neither JAX nor the reference package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.core.query_torch import DeviceQueryEngine
from repro_torch.core.workload import random_queries
from repro_torch.graphs.generators import layered_dag, scale_free_digraph
from repro_torch.kernels import _lib
from repro_torch.kernels import frontier_fused as ff
from repro_torch.kernels.interval_stab import (stab_naive, stab_naive_plain,
                                               stab_packed,
                                               stab_packed_plain)
from repro_torch.reach import IndexSpec, QuerySession, build

pytestmark = pytest.mark.cuda
SENTINEL = 2**31 - 1


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
