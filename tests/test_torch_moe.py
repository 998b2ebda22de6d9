"""The port's MoE LMs and int8 KV cache (``models/transformer.py``,
``models/attention.py``) on the CPU against the JAX package, at the
SMOKE configs of moonshot-v1-16b-a3b (8 experts, top 2, 4 kv heads of 4
heads) and phi3.5-moe-42b-a6.6b (4 experts, top 2, GQA group 2), with
the reference's params carried across by ``params_from_arrays("lm",
...)``:

- the MoE FFN under both reference dispatches ("sort" and "cumsum"), a
  drop-heavy capacity, a decode-sized batch (C = 1) and a zero router
  (every probability equal: the route and the [E, C] token tables);
- ``_quantize_token`` and ``quantize_cache`` bit for bit against the
  reference's ``_quantize_token`` and its int8 test's ``_quantize_all``;
- ``decode_attention`` with scales;
- ``forward``, ``prefill`` and 8 int8 decode steps against the
  reference's int8 decode path (``tests/test_kv_int8.py::_decode_run``);
- the prefill and decode cells, ``generate`` and ``serve_lm``.

Inputs are numpy, from a seed. Tolerances: the MoE FFN and the decode
attention at rtol 1e-5 / atol 1e-6 (one float32 layer); a whole model's
logits at rtol 1e-4 and atol 1e-5 times their largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kv_int8 import _decode_run, _quantize_all

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.models import api as ref_api
from repro.models import transformer as ref_tf
from repro.models.attention import decode_attention as ref_decode
from repro.parallel.sharding import NO_SHARDING
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import MoESpec, shapes_for_family
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.models.attention import decode_attention
from repro_torch.models.convert import params_from_arrays

pytestmark = pytest.mark.arch

MOE_ARCHS = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")
FFN_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5       # atol times max|want|


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(arch, seed=0):
    cfg = ref_get_smoke(arch)
    p = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, p, params_from_arrays("lm", _np(p), "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(want).max())


def _layer0(p):
    return {k: v[0] for k, v in p["layers"].items()}


def _ref_tables(cfg, router, xf):
    """The reference's route and [E, C] tables: ``_moe_ffn_gather``'s
    lines from the logits to ``token_tbl`` / ``gate_tbl`` under its
    ``cfg.moe.dispatch``, in jax."""
    moe = cfg.moe
    G = xf.shape[0]
    E, K = moe.n_experts, moe.top_k
    C = max(int(G * K / E * moe.capacity_factor), 1)
    logits = jnp.einsum("gd,de->ge", xf.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, K)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    flat_e = top_e.reshape(-1)
    if moe.dispatch == "sort":
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        starts = jnp.searchsorted(sorted_e, jnp.arange(E, dtype=flat_e.dtype))
        pos_sorted = (jnp.arange(G * K, dtype=jnp.int32)
                      - starts[sorted_e].astype(jnp.int32))
        pos = jnp.zeros(G * K, jnp.int32).at[order].set(pos_sorted)
    else:
        onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
        pos = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(G * K), flat_e]
    slot = jnp.where(pos < C, flat_e * C + pos, E * C)
    token_of = jnp.zeros(E * C + 1, jnp.int32).at[slot].set(
        jnp.repeat(jnp.arange(G, dtype=jnp.int32), K), mode="drop")
    gate_of = jnp.zeros(E * C + 1, jnp.float32).at[slot].set(
        top_p.reshape(-1), mode="drop")
    return (np.asarray(top_e), np.asarray(pos),
            np.asarray(token_of[:-1].reshape(E, C)),
            np.asarray(gate_of[:-1].reshape(E, C)))


# ------------------------------------------------------------- configs ----

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_reference(arch):
    assert set(ARCHS) == set(REF_ARCHS)
    for port, ref in ((get_config, ref_get_config),
                      (get_smoke, ref_get_smoke)):
        got, want = port(arch), ref(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        assert got.param_count() == want.param_count()
    assert get_config(arch).kv_cache_dtype == "int8"
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(
        MoESpec)] == [(f.name, f.type, f.default) for f in dataclasses.fields(
            type(ref_get_config(arch).moe))]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_and_int8_cache_match_reference_tree(arch):
    cfg, pcfg = ref_get_smoke(arch), get_smoke(arch)
    got = tf.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    want = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"]) == set(
        tf.MOE_LAYER_LEAVES)
    for g_tree, w_tree in ((got, want), (got["layers"], want["layers"])):
        for key, w in w_tree.items():
            if isinstance(w, dict):
                continue
            assert tuple(g_tree[key].shape) == w.shape, key
            assert str(g_tree[key].dtype).split(".")[-1] == str(w.dtype), key
    bf16 = dataclasses.replace(pcfg, dtype="bfloat16")
    lay = tf.init_params(bf16, torch.Generator().manual_seed(0),
                         "cpu")["layers"]
    assert lay["router"].dtype == torch.float32
    assert lay["w_up"].dtype == torch.bfloat16
    # the reference's scales: router and w_gate N(0, 1/D), w_down N(0, 1/F)
    D, F = pcfg.d_model, pcfg.d_ff
    for name, fan in (("router", D), ("w_gate", D), ("w_down", F)):
        assert abs(float(got["layers"][name].std()) * fan ** 0.5 - 1) < 0.05
    c = tf.init_cache(pcfg, 2, 16, "cpu")
    w = ref_tf.init_cache(cfg, 2, 16)
    assert set(c) == set(w) == {"k", "v", "k_scale", "v_scale"}
    for key in w:
        assert tuple(c[key].shape) == w[key].shape
        assert str(c[key].dtype).split(".")[-1] == str(w[key].dtype)


# ------------------------------------------------------------- MoE FFN ----

FFN_CASES = [
    # (arch, dispatch, capacity_factor, batch, seq)
    *((a, d, None, 2, 24) for a in MOE_ARCHS for d in ("sort", "cumsum")),
    ("moonshot-v1-16b-a3b", "sort", 0.25, 2, 24),      # drop-heavy
    ("phi3.5-moe-42b-a6.6b", "cumsum", 0.25, 3, 16),
    ("moonshot-v1-16b-a3b", "sort", None, 2, 1),       # decode: G 2, C 1
    ("phi3.5-moe-42b-a6.6b", "sort", None, 1, 1),      # G 1, C 1
]


def _moe_case(arch, dispatch, cf, b, s, seed=0):
    cfg = ref_get_smoke(arch)
    moe = dataclasses.replace(cfg.moe, dispatch=dispatch)
    if cf is not None:
        moe = dataclasses.replace(moe, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, moe=moe)
    p = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    lp = _layer0(p)
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return cfg, lp, x


@pytest.mark.parametrize("arch,dispatch,cf,b,s", FFN_CASES)
def test_moe_ffn_matches_reference(arch, dispatch, cf, b, s):
    cfg, lp, x = _moe_case(arch, dispatch, cf, b, s)
    pcfg = dataclasses.replace(get_smoke(arch), moe=cfg.moe)
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    want = ref_tf._moe_ffn_gather(cfg, lp, jnp.asarray(x), NO_SHARDING)
    got = tf._moe_ffn(pcfg, tlp, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)

    # every discrete choice: the route, the queue positions, the tables
    G = b * s
    C = tf.capacity(pcfg.moe, G)
    xf = x.reshape(G, -1)
    top_e, pos, token_tbl, gate_tbl = _ref_tables(cfg, lp["router"], xf)
    gates, experts = tf.route(pcfg.moe, tlp["router"], torch.from_numpy(xf))
    np.testing.assert_array_equal(experts.numpy(), top_e)
    np.testing.assert_array_equal(
        tf.queue_positions(experts.reshape(-1), pcfg.moe.n_experts).numpy(),
        pos)
    tok, gate, slot = tf.dispatch_tables(gates, experts, pcfg.moe.n_experts,
                                         C)
    assert tok.shape == (pcfg.moe.n_experts, C)
    assert tuple(slot.shape) == top_e.shape
    np.testing.assert_array_equal(tok.numpy(), token_tbl)
    np.testing.assert_allclose(gate.numpy(), gate_tbl, **FFN_TOL)
    dropped = int((pos >= C).sum())
    if cf == 0.25:
        assert dropped > 0.3 * pos.size, (dropped, pos.size)
    if s == 1:
        assert C == 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_zero_router_ties_go_to_the_lower_expert(arch):
    """Every probability equal: top-K takes experts 0..K-1 for every token,
    as ``jax.lax.top_k`` does, and the token tables are the reference's
    (expert e's queue is the tokens in order, cut at C)."""
    cfg, lp, x = _moe_case(arch, "sort", None, 2, 12, seed=3)
    lp = {**lp, "router": jnp.zeros_like(lp["router"])}
    pcfg = get_smoke(arch)
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    K, E = pcfg.moe.top_k, pcfg.moe.n_experts
    xf = x.reshape(24, -1)
    gates, experts = tf.route(pcfg.moe, tlp["router"], torch.from_numpy(xf))
    np.testing.assert_array_equal(experts.numpy(),
                                  np.tile(np.arange(K), (24, 1)))
    np.testing.assert_allclose(gates.numpy(), 1.0 / K, rtol=1e-6)
    for dispatch in ("sort", "cumsum"):
        dcfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
        top_e, _, token_tbl, gate_tbl = _ref_tables(dcfg, lp["router"], xf)
        np.testing.assert_array_equal(experts.numpy(), top_e)
        tok, gate, _ = tf.dispatch_tables(gates, experts, E,
                                          tf.capacity(pcfg.moe, 24))
        np.testing.assert_array_equal(tok.numpy(), token_tbl)
        np.testing.assert_array_equal(gate.numpy(), gate_tbl)
        want = ref_tf._moe_ffn_gather(dcfg, lp, jnp.asarray(x), NO_SHARDING)
        got = tf._moe_ffn(pcfg, tlp, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)


def test_moe_ffn_bf16_matches_reference():
    """bfloat16 weights and activations, a float32 router: the same route
    (the logits are float32 in both), the products and the combine in
    bfloat16, within bfloat16 rounding."""
    cfg, lp, x = _moe_case("moonshot-v1-16b-a3b", "sort", None, 2, 16)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    lp = {k: v if k == "router" else v.astype(jnp.bfloat16)
          for k, v in lp.items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(ref_tf._moe_ffn_gather(cfg, lp, xb, NO_SHARDING),
                      np.float32)
    tlp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in lp.items()}
    got = tf._moe_ffn(dataclasses.replace(get_smoke("moonshot-v1-16b-a3b"),
                                          dtype="bfloat16"),
                      tlp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


# ---------------------------------------------------------- int8 cache ----

def test_quantize_token_and_cache_bit_exact():
    rng = np.random.default_rng(5)
    tok = rng.standard_normal((3, 1, 4, 32)).astype(np.float32) * 3
    tok[0, 0, 1] = 0.0                       # an all-zero row: scale 1e-8
    tok[1, 0, 2, :4] = [127.5, -127.5, 0.5, -0.5]   # halves: to even
    q_w, s_w = ref_tf._quantize_token(jnp.asarray(tok))
    q_g, s_g = tf._quantize_token(torch.from_numpy(tok))
    assert q_g.dtype == torch.int8 and s_g.dtype == torch.float32
    np.testing.assert_array_equal(q_g.numpy(), np.asarray(q_w))
    np.testing.assert_array_equal(s_g.numpy(), np.asarray(s_w))
    for dt in (np.float32, jnp.bfloat16):
        cache = rng.standard_normal((2, 2, 9, 3, 16)).astype(np.float32)
        jk = jnp.asarray(cache, dt)
        tk = torch.from_numpy(np.asarray(jk, np.float32)).to(
            torch.float32 if dt is np.float32 else torch.bfloat16)
        got = tf.quantize_cache({"k": tk, "v": tk * 2})
        for name, src in (("k", jk), ("v", jk * 2)):
            q, s = _quantize_all(src)
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(q))
            np.testing.assert_array_equal(got[f"{name}_scale"].numpy(),
                                          np.asarray(s))


@pytest.mark.parametrize("h,kv,pos", [(4, 2, 40), (6, 2, 17), (4, 4, 63)])
def test_decode_attention_int8_matches_reference(h, kv, pos):
    rng = np.random.default_rng(h * 10 + kv)
    q = rng.standard_normal((2, 1, h, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, kv, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 64, kv, 32)).astype(np.float32)
    (kq, ks), (vq, vs) = _quantize_all(k), _quantize_all(v)
    want = ref_decode(jnp.asarray(q), kq[0], vq[0], jnp.int32(pos),
                      k_scale=ks[0], v_scale=vs[0])
    got = decode_attention(*(torch.from_numpy(np.asarray(a)) for a in (
        q, kq[0], vq[0])), pos, k_scale=torch.from_numpy(np.asarray(ks[0])),
        v_scale=torch.from_numpy(np.asarray(vs[0])))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="both"):
        decode_attention(torch.from_numpy(q), torch.from_numpy(
            np.asarray(kq[0])), torch.from_numpy(np.asarray(vq[0])), pos,
            k_scale=torch.from_numpy(np.asarray(ks[0])))


# --------------------------------------------------------------- model ----

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch):
    cfg, p, tp = _params(arch)
    toks = _tokens(cfg, 2, 24)
    want = np.asarray(ref_tf.forward(cfg, p, jnp.asarray(toks)))
    got = tf.forward(get_smoke(arch), tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(want).max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_int8_decode_match_reference(arch):
    """The reference's int8 decode path (``_decode_run``: prefill, the
    cache re-encoded by ``_quantize_all``, greedy decode steps) against
    the port's ``prefill``, ``quantize_cache`` and ``decode_step``.

    The decode logits are held at the stated tolerance from the same int8
    cache (the reference's re-encode, handed to the port): the two
    prefills' float32 caches differ by rounding, and a value of theirs
    that lies at a rounding tie of the quantization may land one quantum
    apart, which moves the logits by ~1e-4 of their largest magnitude.
    The port's own re-encode is held within one quantum of the
    reference's in at most 0.1% of the values, and its whole path
    (``generate``) by its greedy tokens."""
    cfg, p, tp = _params(arch, seed=1)
    pcfg = get_smoke(arch)
    toks = _tokens(cfg, 2, 20, seed=1)
    steps = 8
    want_toks, want_logits = _decode_run(cfg, p, jnp.asarray(toks), steps)
    want0, jcache = ref_tf.prefill(cfg, p, jnp.asarray(toks), 20 + steps)

    logits, cache = tf.prefill(pcfg, tp, torch.from_numpy(toks), 20 + steps)
    assert cache["k"].dtype == torch.float32          # the model's dtype
    _logits_close(logits, want0)
    own = tf.quantize_cache(cache)
    ref_cache = {}
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-5)
        q, sc = _quantize_all(jcache[name])
        ref_cache[name], ref_cache[f"{name}_scale"] = q, sc
        off = np.abs(own[name].numpy().astype(int) - np.asarray(q, int))
        assert off.max() <= 1 and (off > 0).mean() <= 1e-3, (
            name, int((off > 0).sum()))
        np.testing.assert_allclose(own[f"{name}_scale"].numpy(),
                                   np.asarray(sc), rtol=1e-5)

    tcache = {k: torch.from_numpy(np.array(v)) for k, v in ref_cache.items()}
    cur = logits.argmax(-1, keepdim=True).to(torch.int32)
    got_toks = [cur]
    for i in range(steps):
        logits, tcache = tf.decode_step(pcfg, tp, tcache, cur, 20 + i)
        _logits_close(logits, want_logits[i])
        cur = logits.argmax(-1, keepdim=True).to(torch.int32)
        got_toks.append(cur)
    np.testing.assert_array_equal(torch.cat(got_toks, 1).numpy(),
                                  np.asarray(want_toks))
    assert tcache["k"].dtype == torch.int8
    assert bool(tcache["k_scale"][:, :, 20 + steps - 1].gt(0).all())

    res = serve.generate(pcfg, tp, torch.from_numpy(toks), steps + 1)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(want_toks))
    assert res["quantize_s"] > 0


def test_int8_decode_needs_an_int8_cache():
    _, _, tp = _params("moonshot-v1-16b-a3b")
    pcfg = get_smoke("moonshot-v1-16b-a3b")
    _, cache = tf.prefill(pcfg, tp, torch.zeros((1, 4), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="quantize_cache"):
        tf.decode_step(pcfg, tp, cache, torch.zeros((1, 1),
                                                    dtype=torch.int32), 4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cells_match_reference(arch):
    cfg, pcfg = ref_get_smoke(arch), get_smoke(arch)
    b, s = 2, 16
    outs = {}
    for name in ("prefill_32k", "decode_32k"):
        shp = dataclasses.replace(shapes_for_family("lm")[name], batch=b,
                                  seq_len=s)
        ref_cell = ref_api.build_cell(cfg, name, shape_override=shp)
        cell = api.build_cell(pcfg, name, device="cpu", shape_override=shp)
        assert cell.kind == ref_cell.kind
        state = ref_api.materialize_state(ref_cell, cfg, name,
                                          jax.random.PRNGKey(3))
        tp = params_from_arrays("lm", _np(state["params"]), "cpu")
        if name == "prefill_32k":
            toks = _tokens(cfg, b, s, seed=3)
            _, want = ref_cell.step(state, {"tokens": jnp.asarray(toks)})
            _, got = cell.step({"params": tp},
                               {"tokens": torch.from_numpy(toks)})
            _logits_close(got["logits"], want["logits"])
            for key in ("k", "v"):
                np.testing.assert_allclose(got["cache"][key].numpy(),
                                           np.asarray(want["cache"][key]),
                                           rtol=1e-4, atol=1e-5)
            outs["cache"] = (want["cache"], got["cache"])
            continue
        # decode at position s - 1 of the prefill's cache, re-encoded
        jcache, tcache = outs["cache"]
        kq, ks = _quantize_all(jcache["k"])
        vq, vs = _quantize_all(jcache["v"])
        jcache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        tcache = tf.quantize_cache(tcache)
        tok = _tokens(cfg, b, 1, seed=4)
        new, want = ref_cell.step(
            {"params": state["params"], "cache": jcache},
            {"token": jnp.asarray(tok), "pos": jnp.int32(s - 1)})
        tnew, got = cell.step(
            {"params": tp, "cache": tcache},
            {"token": torch.from_numpy(tok),
             "pos": torch.tensor(s - 1, dtype=torch.int32)})
        _logits_close(got, want)
        for key in ("k", "v"):
            col = np.asarray(new["cache"][key])[:, :, s - 1]
            assert np.abs(tnew["cache"][key][:, :, s - 1].numpy().astype(
                int) - col.astype(int)).max() <= 1
        # the decode cell's own state holds the int8 cache
        st = api.materialize_state(cell, pcfg, name,
                                   torch.Generator().manual_seed(0))
        assert st["cache"]["k"].dtype == torch.int8
        assert tuple(st["cache"]["v_scale"].shape) == (
            pcfg.n_layers, b, s, pcfg.n_kv_heads)


def test_serve_lm_moe_on_cpu(capsys):
    res = serve.serve_lm("moonshot-v1-16b-a3b", 2, 12, 5, device="cpu")
    assert res["tokens"].shape == (2, 5) and res["decode_steps"] == 4
    assert int(res["tokens"].max()) < get_smoke("moonshot-v1-16b-a3b").vocab
    assert "int8 cache re-encoded" in capsys.readouterr().out


def test_convert_takes_the_moe_leaf_set():
    _, p, tp = _params("phi3.5-moe-42b-a6.6b")
    assert set(tp["layers"]) == set(tf.MOE_LAYER_LEAVES)
    assert tp["layers"]["router"].dtype == torch.float32
    tree = _np(p)
    no_router = {k: v for k, v in tree["layers"].items() if k != "router"}
    with pytest.raises(KeyError):
        params_from_arrays("lm", {**tree, "layers": no_router}, "cpu")
    extra = {**tree["layers"], "w_extra": tree["layers"]["wq"]}
    with pytest.raises(KeyError):
        params_from_arrays("lm", {**tree, "layers": extra}, "cpu")
