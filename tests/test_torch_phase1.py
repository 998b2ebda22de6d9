"""Phase 1 of the port on the CPU: the plain versions of kernels 1 and 2
(and the engine-facing ``ops.classify_queries``) give the same verdicts as
the reference's ``kernels.ref`` oracles and its Pallas kernels run in
interpret mode, on the same seeded inputs. Mirrors tests/test_kernels.py
and tests/test_kernels_packed.py. Every value is an integer: exact
equality, no tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ferrari import build_index as ref_build
from repro.core.packed import pack_index as ref_pack
from repro.graphs import generators as ref_gen
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.interval_stab import (interval_stab_classify,
                                         interval_stab_classify_packed)
from repro_torch.core.ferrari import build_index
from repro_torch.core.packed import pack_index
from repro_torch.graphs import generators as gen
from repro_torch.kernels import ops, ref
from repro_torch.kernels.interval_stab import stab_naive, stab_packed

INT32_MAX = 2**31 - 1


def _t(a):
    """numpy → int32 CPU tensor (uint32 words as int32 views)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32,
                                                          copy=False)))


def _seed_words(rng, shape):
    """Sparse uint32 seed words (mostly zero, bit 31 included), so every
    seed rule both fires and stays silent across a batch."""
    bit = rng.integers(0, 32, shape).astype(np.uint32)
    w = np.where(rng.random(shape) < 0.3, np.uint32(1) << bit, np.uint32(0))
    return w.astype(np.uint32)


# ------------------------------------------------------------- kernel 2
def _naive_rows(rng, q, k, w):
    tgt = rng.integers(0, 1000, q).astype(np.int32)
    tau_s = rng.integers(0, 1000, q).astype(np.int32)
    tau_t = rng.integers(0, 1000, q).astype(np.int32)
    lvl_s = rng.integers(0, 400, q).astype(np.int32)     # unsaturated > 255
    lvl_t = rng.integers(0, 400, q).astype(np.int32)
    # half the pairs pass the τ and level filters, so UNKNOWN shows up
    ok = rng.random(q) < 0.5
    tau_t = np.where(ok, tau_s + 1 + rng.integers(0, 9, q), tau_t)
    lvl_t = np.where(ok, lvl_s - 1 - rng.integers(0, 9, q), lvl_t)
    tau_t, lvl_t = tau_t.astype(np.int32), lvl_t.astype(np.int32)
    b = np.sort(rng.integers(0, 1000, (q, k)), axis=1).astype(np.int32)
    e = (b + rng.integers(0, 60, (q, k))).astype(np.int32)
    x = rng.integers(0, 2, (q, k)).astype(np.int32)
    invalid = rng.random((q, k)) < 0.2                   # INVALID pad slots
    # half the targets fall inside one of the row's intervals
    j = rng.integers(0, k, q)
    inside = (b[np.arange(q), j] + e[np.arange(q), j]) // 2
    tgt = np.where(rng.random(q) < 0.5, inside, tgt).astype(np.int32)
    b[invalid], e[invalid], x[invalid] = INT32_MAX, -1, 0
    seeds = [_seed_words(rng, (q, w)) for _ in range(4)]
    return (tgt, tau_s, tau_t, lvl_s, lvl_t, b, e, x, *seeds)


@pytest.mark.parametrize("q,k,w", [
    (64, 1, 1), (100, 3, 1), (777, 5, 2), (300, 8, 2), (129, 32, 1),
    (200, 2, 4),
])
def test_naive_ref_matches_reference(q, k, w):
    rows = _naive_rows(np.random.default_rng(q + k + w), q, k, w)
    want = np.asarray(jref.interval_stab_classify_ref(
        *(jnp.asarray(a) for a in rows)))
    got = ref.interval_stab_classify_ref(*(_t(a) for a in rows)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(want)) == {0, 1, 2}


@pytest.mark.parametrize("q,k,w", [(100, 3, 1), (300, 8, 2), (129, 32, 1)])
def test_stab_naive_matches_pallas_interpret(q, k, w):
    """Kernel 2's wrapper gathers rows itself: lay the per-query rows out
    as a table (sources in rows [0, q), targets in [q, 2q))."""
    rows = _naive_rows(np.random.default_rng(7 * q + k), q, k, w)
    tgt, tau_s, tau_t, lvl_s, lvl_t, b, e, x, sps, sms, spt, smt = rows
    want = np.asarray(interval_stab_classify(
        *(jnp.asarray(a) for a in rows), block_q=128, interpret=True))
    cat = np.concatenate
    tables = (cat([np.zeros(q, np.int32), tgt]), cat([tau_s, tau_t]),
              cat([lvl_s, lvl_t]), cat([b, b]), cat([e, e]), cat([x, x]),
              cat([sps, spt]), cat([sms, smt]))
    cs = torch.arange(q, dtype=torch.int32)
    got = stab_naive(*(_t(a) for a in tables), cs, cs + q).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- kernel 1
def _packed_tables(rng, n, k):
    pi = rng.integers(0, 1 << 24, n).astype(np.uint32)
    # levels across the sign bit (>= 128) and saturated at 255
    lvl = rng.choice(np.array([0, 1, 5, 127, 128, 200, 254, 255]), n)
    word0 = (pi | (lvl.astype(np.uint32) << np.uint32(24))).view(np.int32)
    tau = rng.integers(0, 1000, n).astype(np.int32)
    meta = np.stack([word0, tau, _seed_words(rng, n).view(np.int32),
                     _seed_words(rng, n).view(np.int32)], axis=1)
    # begins around the targets' π so that hits happen
    b = np.sort(rng.integers(0, 1 << 24, (n, k)), axis=1).astype(np.int64)
    e = b + rng.integers(0, 1 << 22, (n, k))
    near = rng.integers(0, n, (n, k))
    b = np.where(rng.random((n, k)) < 0.5, pi[near].astype(np.int64) - 3, b)
    e = np.where(rng.random((n, k)) < 0.5, pi[near].astype(np.int64) + 3, e)
    b = np.clip(b, 0, (1 << 24) - 1)
    e = np.clip(e, b, (1 << 24) - 1)
    x = rng.random((n, k)) < 0.3
    invalid = rng.random((n, k)) < 0.2
    b = np.where(invalid, INT32_MAX, b).astype(np.uint32)
    e = np.where(invalid, -1, e).astype(np.int32)
    braw = (b | ((x & ~invalid).astype(np.uint32) << np.uint32(31)))
    slab = np.concatenate([braw.view(np.int32), e], axis=1)
    return np.ascontiguousarray(meta), np.ascontiguousarray(slab)


def _pairs(rng, n, q):
    cs = rng.integers(0, n, q).astype(np.int32)
    ct = rng.integers(0, n, q).astype(np.int32)
    ct[: q // 8] = cs[: q // 8]                  # the cs == ct fold
    return cs, ct


@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_stab_packed_matches_reference(k):
    rng = np.random.default_rng(k)
    n, q = 600, 777
    meta, slab = _packed_tables(rng, n, k)
    cs, ct = _pairs(rng, n, q)
    jm, js, jcs, jct = (jnp.asarray(a) for a in (meta, slab, cs, ct))
    want_kernel = np.asarray(jnp.where(
        jcs == jct, jref.POS,
        interval_stab_classify_packed(jm[jcs], jm[jct], js[jcs],
                                      block_q=256, interpret=True)))
    want_ref = np.asarray(jref.classify_packed_dev_ref(
        {"meta": jm, "slab": js}, jcs, jct))
    got = stab_packed(_t(meta), _t(slab), _t(cs), _t(ct)).numpy()
    np.testing.assert_array_equal(want_kernel, want_ref)
    np.testing.assert_array_equal(got, want_kernel)
    assert set(np.unique(got)) == {0, 1, 2}
    # the saturated-level and sign-bit rows really were exercised
    assert ((meta[cs, 0] >> 24) & 0xFF == 255).any()
    assert (slab[cs, :k] < 0).any()


def test_packed_ref_oracle_matches_reference():
    rng = np.random.default_rng(11)
    meta, slab = _packed_tables(rng, 500, 4)
    cs, ct = _pairs(rng, 500, 500)
    want = np.asarray(jref.interval_stab_classify_packed_ref(
        jnp.asarray(meta[cs]), jnp.asarray(meta[ct]), jnp.asarray(slab[cs])))
    got = ref.interval_stab_classify_packed_ref(
        _t(meta[cs]), _t(meta[ct]), _t(slab[cs])).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------- ops.classify_queries (index)
@pytest.mark.parametrize("graph,n_seeds,k", [
    ("random", 8, 3), ("scale_free", 32, 2), ("scale_free", 64, 2),
    ("deep", 8, 2), ("random", 0, 1),
])
def test_classify_queries_matches_reference(graph, n_seeds, k):
    """Real indexes, both layouts: fused (≤ 32 seeds), 12-array (64
    seeds), saturated levels (a 400-deep path DAG), and no seeds."""
    make = {"random": lambda m: m.random_dag(400, 2.0, seed=4),
            "scale_free": lambda m: m.scale_free_digraph(500, 3.0, seed=6),
            "deep": lambda m: m.deep_path_dag(400, branch_p=0.02, seed=1)}
    kw = dict(k=k, variant="G", use_seeds=n_seeds > 0,
              n_seeds=max(n_seeds, 1))
    p_ref = ref_pack(ref_build(make[graph](ref_gen), **kw))
    p = pack_index(build_index(make[graph](gen), **kw))
    dev_ref, dev = p_ref.to_device(), p.to_torch("cpu")
    assert ("slab" in dev) == (n_seeds <= 32)
    if graph == "deep":
        assert int(p.blevel.max()) > 255
    rng = np.random.default_rng(n_seeds + k)
    cs, ct = _pairs(rng, p.n, 700)
    want = np.asarray(ref_ops.classify_queries(
        dev_ref, jnp.asarray(cs), jnp.asarray(ct), use_pallas=True,
        block_q=256))
    want_ref = np.asarray(jref.classify_packed_dev_ref(
        dev_ref, jnp.asarray(cs), jnp.asarray(ct)))
    got = ops.classify_queries(dev, _t(cs), _t(ct)).numpy()
    np.testing.assert_array_equal(want, want_ref)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ref.classify_packed_dev_ref(dev, _t(cs), _t(ct)).numpy(), want)
    assert (got[cs == ct] == ops.POS).all()


def test_classify_all_nodes_vs_target_matches_reference():
    g_ref, g = (m.layered_dag(300, 12, 3.0, seed=3) for m in (ref_gen, gen))
    kw = dict(k=1, variant="L", use_seeds=False)
    dev_ref = ref_pack(ref_build(g_ref, **kw)).to_device()
    dev = pack_index(build_index(g, **kw)).to_torch("cpu")
    ct = np.random.default_rng(0).integers(0, dev["pi"].shape[0], 16)
    e_ref, p_ref = ref_ops.classify_all_nodes_vs_target(
        dev_ref, jnp.asarray(ct, jnp.int32))
    e, p = ops.classify_all_nodes_vs_target(dev, _t(ct))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    assert e.any() and p.any()


class _Elsewhere:
    """A tensor's stand-in on a device that is neither the CPU, a card nor
    ``meta`` (this build of PyTorch makes no such tensor)."""
    device = torch.device("xpu")
    shape = (4,)


def test_wrappers_reject_other_devices():
    t = _Elsewhere()
    with pytest.raises(ValueError, match="unsupported device"):
        stab_packed(t, t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        stab_naive(*[t] * 10)
    # ``meta`` (a dry run) takes its own branch: the verdicts allocated,
    # nothing launched
    m = torch.zeros(4, dtype=torch.int32, device="meta")
    v = stab_packed(m.view(1, 4), m.view(1, 4), m, m)
    assert (v.shape, v.dtype, v.device.type) == ((4,), torch.int32, "meta")
