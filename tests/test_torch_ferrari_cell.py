"""ferrari-web in the port: the arch's config and registry line, the spec it
derives (``IndexSpec.from_config``), and its classify cell against the
reference's on the CPU — the same built index, verdict for verdict — plus
kernel 1's plain version against the reference's packed stab kernel in
interpret mode on rows that use all 24 bits of π and a saturated level,
as the published n = 2**24 does. Every value is an integer: exact
equality, no tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import shapes_for_family as ref_shapes
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.core.packed import pack_index as ref_pack
from repro.graphs import generators as ref_gen
from repro.kernels import ref as jref
from repro.kernels.interval_stab import interval_stab_classify_packed
from repro.models import api as ref_api
from repro.reach import IndexSpec as RefSpec
from repro.reach import build as ref_build
from repro.reach import save_index as ref_save
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.core.packed import pack_index
from repro_torch.kernels import ops
from repro_torch.kernels.interval_stab import stab_packed
from repro_torch.models import api
from repro_torch.reach import IndexSpec, load_index

INT32_MAX = 2**31 - 1
ARCH = "ferrari-web"


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32,
                                                          copy=False)))


def test_registry_and_configs_match_reference():
    assert ARCH in ARCHS and ARCH in REF_ARCHS
    assert set(ARCHS) == set(REF_ARCHS)
    for port, ref in ((get_config, ref_get_config),
                      (get_smoke, ref_get_smoke)):
        assert dataclasses.asdict(port(ARCH)) == dataclasses.asdict(
            ref(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.n_nodes, cfg.k_max, cfg.seed_words, cfg.family) == (
        16_777_216, 8, 1, "ferrari")
    assert ({k: dataclasses.asdict(v)
             for k, v in shapes_for_family("ferrari").items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_shapes("ferrari").items()})
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("ferrari-web-2")


@pytest.mark.parametrize("which,overrides", [
    ("config", {}), ("smoke", {}),
    ("config", {"precondensed": True}),
    ("config", {"c": 2}), ("smoke", {"k": 3, "n_seeds": 8}),
    ("smoke", {"c": 8, "phase2_mode": "sparse"}),
])
def test_from_config_matches_reference(which, overrides):
    get, ref_get = ((get_config, ref_get_config) if which == "config"
                    else (get_smoke, ref_get_smoke))
    got = IndexSpec.from_config(get(ARCH), **overrides)
    want = RefSpec.from_config(ref_get(ARCH), **overrides)
    assert got.to_dict() == want.to_dict()
    if "k" not in overrides:
        assert got.k == max(1, get(ARCH).k_max // got.c)


@pytest.fixture(scope="module")
def smoke_index(tmp_path_factory):
    """The SMOKE width (n 4096, k_max 4) over a condensed DAG, built once
    by the reference and loaded by both packages."""
    cfg = ref_get_smoke(ARCH)
    g = ref_gen.scale_free_digraph(cfg.n_nodes, 4.0, seed=3, back_p=0.0)
    spec = RefSpec.from_config(cfg, precondensed=True)
    ix = ref_build(g, spec)
    path = tmp_path_factory.mktemp("ferrari_smoke")
    ref_save(path, ix, spec)
    art = load_index(path)
    return cfg, ix, art


@pytest.mark.parametrize("shape_name", ["classify_100k", "classify_16m"])
def test_cell_shapes_match_reference(shape_name):
    cfg = get_config(ARCH)
    cell = api.build_cell(cfg, shape_name, device="cpu")
    want = ref_api.build_cell(ref_get_config(ARCH), shape_name)
    assert cell.kind == want.kind == "classify"
    for got_shapes, sds in ((cell.batch_shapes, want.batch_sds),
                            (cell.state_shapes, want.state_sds)):
        assert {k: (tuple(s), d) for k, (s, d) in got_shapes.items()} == {
            k: (tuple(v.shape), torch.int32) for k, v in sds.items()}
        assert all(str(v.dtype) == "int32" for v in sds.values())
    assert cell.model_flops_fn() == want.model_flops_fn()
    # the cell runs replicated: the sharded placement needs a mesh
    assert cfg.index_placement == "sharded"
    with pytest.raises(ValueError, match="PackedIndex"):
        api.materialize_state(cell, cfg, shape_name, torch.Generator())


def test_smoke_cell_matches_reference(smoke_index):
    cfg, ref_ix, art = smoke_index
    K = cfg.k_max
    ref_pk = ref_pack(ref_ix, k_max=K)
    pk = pack_index(art.index, k_max=K)
    dev = pk.to_torch("cpu", fused=True)
    ref_dev = ref_pk.to_device()
    state = {"slab": dev["slab"], "meta": dev["meta"]}
    np.testing.assert_array_equal(state["slab"].numpy(),
                                  np.asarray(ref_dev["slab"]))
    np.testing.assert_array_equal(state["meta"].numpy(),
                                  np.asarray(ref_dev["meta"]))
    cell = api.build_cell(cfg, "classify_100k", device="cpu")
    ref_cell = ref_api.build_cell(ref_get_smoke(ARCH), "classify_100k")
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: s for k, (s, _) in cell.state_shapes.items()}
    (Q,), _ = cell.batch_shapes["cs"]
    rng = np.random.default_rng(5)
    cs = rng.integers(0, cfg.n_nodes, Q).astype(np.int32)
    ct = rng.integers(0, cfg.n_nodes, Q).astype(np.int32)
    ct[:Q // 16] = cs[:Q // 16]                          # the cs == ct fold
    _, got = cell.step(state, {"cs": _t(cs), "ct": _t(ct)})
    _, want = ref_cell.step({"slab": ref_dev["slab"],
                             "meta": ref_dev["meta"]},
                            {"cs": jnp.asarray(cs), "ct": jnp.asarray(ct)})
    want = np.asarray(want)
    assert got.dtype == torch.int32 and got.shape == (Q,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {ops.NEG, ops.POS, ops.UNKNOWN}


def _high_pi_tables(rng, n, k):
    """Meta rows whose π has bit 23 set (π in [2**23, 2**24)) and whose
    level word is 255 (saturated), with intervals around the targets' π
    up to 2**24 - 1: the rows a 2**24-node index holds at its top."""
    pi = rng.integers(1 << 23, 1 << 24, n).astype(np.uint32)
    word0 = (pi | (np.uint32(255) << np.uint32(24))).view(np.int32)
    tau = rng.integers(0, 1000, n).astype(np.int32)
    bit = rng.integers(0, 32, (2, n)).astype(np.uint32)
    seeds = np.where(rng.random((2, n)) < 0.3, np.uint32(1) << bit,
                     np.uint32(0)).astype(np.uint32)
    meta = np.stack([word0, tau, seeds[0].view(np.int32),
                     seeds[1].view(np.int32)], axis=1)
    near = rng.integers(0, n, (n, k))
    b = pi[near].astype(np.int64) - rng.integers(0, 4, (n, k))
    e = pi[near].astype(np.int64) + rng.integers(0, 4, (n, k))
    far = rng.random((n, k)) < 0.4
    b = np.where(far, rng.integers(1 << 23, 1 << 24, (n, k)), b)
    e = np.where(far, b + rng.integers(0, 1 << 10, (n, k)), e)
    b = np.clip(np.sort(b, axis=1), 1 << 23, (1 << 24) - 1)
    e = np.clip(e, b, (1 << 24) - 1)
    x = rng.random((n, k)) < 0.5
    invalid = rng.random((n, k)) < 0.15
    b = np.where(invalid, INT32_MAX, b).astype(np.uint32)
    e = np.where(invalid, -1, e).astype(np.int32)
    braw = b | ((x & ~invalid).astype(np.uint32) << np.uint32(31))
    slab = np.concatenate([braw.view(np.int32), e], axis=1)
    return np.ascontiguousarray(meta), np.ascontiguousarray(slab)


@pytest.mark.parametrize("k", [2, 8])
def test_stab_plain_matches_reference_at_bit_23(k):
    rng = np.random.default_rng(23 + k)
    n, q = 700, 1024
    meta, slab = _high_pi_tables(rng, n, k)
    assert ((meta[:, 0].view(np.uint32) >> 23) & 1).all()
    assert ((meta[:, 0].view(np.uint32) >> 24) == 255).all()
    cs = rng.integers(0, n, q).astype(np.int32)
    ct = rng.integers(0, n, q).astype(np.int32)
    ct[:q // 8] = cs[:q // 8]
    jm, js, jcs, jct = (jnp.asarray(a) for a in (meta, slab, cs, ct))
    want = np.asarray(jnp.where(
        jcs == jct, jref.POS,
        interval_stab_classify_packed(jm[jcs], jm[jct], js[jcs],
                                      block_q=256, interpret=True)))
    got = stab_packed(_t(meta), _t(slab), _t(cs), _t(ct)).numpy()
    np.testing.assert_array_equal(got, want)
    # hits and misses on these rows both occur: POS, NEG and UNKNOWN
    assert set(np.unique(got)) == {ops.NEG, ops.POS, ops.UNKNOWN}


def test_sparse_chunk_fits_kernel_3_candidates(monkeypatch, tmp_path):
    """At n = 2**24 the COO tail of a scale-free DAG makes q x m_t pass
    kernel 3's candidate bound at the key-packing chunk (127 queries). The
    engine then takes a smaller chunk; the answers stay the reference's.
    Shown here with the bound cut to 8 queries' worth of tail."""
    from repro_torch.kernels import frontier_fused
    g = ref_gen.scale_free_digraph(3000, 4.0, seed=8, back_p=0.0)
    spec = RefSpec(k=1, variant="L", use_seeds=False, phase2_mode="sparse",
                   ell_width=4, phase2_chunk=64, frontier_cap=64,
                   frontier_cap_max=256, precondensed=True)
    ref_save(tmp_path, ref_build(g, spec), spec)
    from repro.reach import QuerySession as RefSession
    from repro.reach import load_index as ref_load
    from repro_torch.reach import QuerySession
    art = load_index(tmp_path)
    sess = QuerySession(art.index, IndexSpec.from_dict(spec.to_dict()),
                        packed=art.packed, ell=art.ell, device="cpu")
    eng = sess.engine
    ell, tsrc = eng._ell()[:2]
    m_t, w = tsrc.shape[0], ell.shape[1]
    assert m_t > 1000 and eng._phase2_chunk_size(w, m_t) == 64
    monkeypatch.setattr(frontier_fused, "MAX_CANDIDATES",
                        1 + 256 * w + 8 * m_t)
    assert eng._phase2_chunk_size(w, m_t) == 8
    rng = np.random.default_rng(2)
    qs = rng.integers(0, g.n, 4000)
    qt = rng.integers(0, g.n, 4000)
    got = sess.query(qs, qt)
    ref = RefSession(ref_load(tmp_path).index, spec)
    np.testing.assert_array_equal(got, ref.query(qs, qt))
    st, want = sess.stats, ref.stats
    assert st.phase2_sparse > 0
    for key in ("n_queries", "n_positive", "phase1_pos", "phase1_neg",
                "phase2_queries"):
        assert getattr(st, key) == getattr(want, key), key
    # the states the loop kept were all built within the bound
    assert all(s.q <= 8 for s in eng._sparse_state.values())
    monkeypatch.setattr(frontier_fused, "MAX_CANDIDATES", 1 + 256 * w)
    with pytest.raises(ValueError, match="no query a step"):
        eng._phase2_chunk_size(w, m_t)
