"""The port's dense LM (``models/transformer.py``) on the CPU against the
JAX package: ``forward``, ``prefill`` and three ``decode_step`` calls at
the SMOKE configs of llama3-8b, tinyllama-1.1b and smollm-360m (head dims
32, 16 and 32; GQA groups of 2, 4 and 3), with the
reference's params carried across by ``params_from_arrays("lm", ...)``;
the prefill and decode cells of both packages' ``build_cell``; the
building blocks; and what is not ported (the MoE archs, the trainer's
checkpoint manager).
Tokens are numpy, from a seed.

Tolerance: rtol 1e-4, atol 1e-5 (float32 layers of matmuls, softmax and
norms, each summed in its own order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as ref_get_smoke
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import MoESpec, shapes_for_family
from repro_torch.launch import serve
from repro_torch.launch.train import Trainer
from repro_torch.models import api, common, transformer
from repro_torch.models.convert import params_from_arrays

pytestmark = pytest.mark.arch

TOL = dict(rtol=1e-4, atol=1e-5)
LM_ARCHS = ("llama3-8b", "tinyllama-1.1b", "smollm-360m")


def _params(arch, seed=0):
    cfg = ref_get_smoke(arch)
    p = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, p, params_from_arrays("lm", jax.tree.map(np.asarray, p),
                                      "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch):
    cfg, p, tp = _params(arch)
    toks = _tokens(cfg, 2, 24)
    want = ref_tf.forward(cfg, p, jnp.asarray(toks))
    got = transformer.forward(get_smoke(arch), tp, torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg, p, tp = _params(arch, seed=1)
    pcfg = get_smoke(arch)
    toks = _tokens(cfg, 2, 20, seed=1)
    max_seq = 24
    want, cache = ref_tf.prefill(cfg, p, jnp.asarray(toks), max_seq)
    got, tcache = transformer.prefill(pcfg, tp, torch.from_numpy(toks),
                                      max_seq)
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    for name in ("k", "v"):
        _close(tcache[name], cache[name])
    step = jax.jit(lambda c, t, pos: ref_tf.decode_step(cfg, p, c, t, pos))
    for i in range(3):
        nxt = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
        want, cache = step(cache, jnp.asarray(nxt), jnp.int32(20 + i))
        got, tcache = transformer.decode_step(pcfg, tp, tcache,
                                              torch.from_numpy(nxt), 20 + i)
        _close(got, want)
        for name in ("k", "v"):
            _close(tcache[name], cache[name])


def test_cells_match_reference():
    arch = "llama3-8b"
    cfg = ref_get_smoke(arch)
    pcfg = get_smoke(arch)
    outs = {}
    for name, b, s in (("prefill_32k", 2, 16), ("decode_32k", 2, 16)):
        shp = dataclasses.replace(shapes_for_family("lm")[name], batch=b,
                                  seq_len=s)
        ref_cell = ref_api.build_cell(cfg, name, shape_override=shp)
        cell = api.build_cell(pcfg, name, device="cpu", shape_override=shp)
        assert cell.kind == ref_cell.kind and cell.device.type == "cpu"
        for key, (shape, dtype) in cell.batch_shapes.items():
            assert tuple(shape) == tuple(ref_cell.batch_sds[key].shape)
            assert str(dtype).split(".")[-1] == str(
                ref_cell.batch_sds[key].dtype)
        state = ref_api.materialize_state(ref_cell, cfg, name,
                                          jax.random.PRNGKey(3))
        tstate = {"params": params_from_arrays(
            "lm", jax.tree.map(np.asarray, state["params"]), "cpu")}
        if name == "prefill_32k":
            toks = _tokens(cfg, b, s, seed=3)
            _, want = ref_cell.step(state, {"tokens": jnp.asarray(toks)})
            _, got = cell.step(tstate, {"tokens": torch.from_numpy(toks)})
            _close(got["logits"], want["logits"])
            _close(got["cache"]["k"], want["cache"]["k"])
            outs["cache"] = (want["cache"], got["cache"])
        else:
            # decode at position s - 1 of the prefill's cache
            jcache, tcache = outs["cache"]
            tok = _tokens(cfg, b, 1, seed=4)
            new, want = ref_cell.step(
                {"params": state["params"], "cache": jcache},
                {"token": jnp.asarray(tok), "pos": jnp.int32(s - 1)})
            tnew, got = cell.step(
                {"params": tstate["params"], "cache": tcache},
                {"token": torch.from_numpy(tok),
                 "pos": torch.tensor(s - 1, dtype=torch.int32)})
            _close(got, want)
            _close(tnew["cache"]["v"], new["cache"]["v"])


def test_materialize_state_matches_reference_tree():
    arch = "tinyllama-1.1b"
    cfg, pcfg = ref_get_smoke(arch), get_smoke(arch)
    shp = dataclasses.replace(shapes_for_family("lm")["decode_32k"], batch=2,
                              seq_len=32)
    cell = api.build_cell(pcfg, "decode_32k", device="cpu",
                          shape_override=shp)
    state = api.materialize_state(cell, pcfg, "decode_32k",
                                  torch.Generator().manual_seed(0))
    want_p = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    want_c = ref_tf.init_cache(cfg, 2, 32)
    got_p = state["params"]
    assert set(got_p) == set(want_p)
    assert set(got_p["layers"]) == set(want_p["layers"])
    for tree_got, tree_want in ((got_p, want_p),
                                (got_p["layers"], want_p["layers"]),
                                (state["cache"], want_c)):
        for key, want in tree_want.items():
            if isinstance(want, dict):
                continue
            got = tree_got[key]
            assert tuple(got.shape) == want.shape, key
            assert str(got.dtype).split(".")[-1] == str(want.dtype), key
    # the reference's scales: the embedding N(0, 1), wq N(0, 1/D)
    assert abs(float(got_p["embed"].std()) - 1.0) < 0.05
    assert abs(float(got_p["layers"]["wq"].std()) * cfg.d_model ** 0.5
               - 1.0) < 0.05
    assert not state["cache"]["k"].any()


def test_building_blocks_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 3, 64)).astype(np.float32)
    pos = np.tile(np.arange(5, 17, dtype=np.int32), (2, 1))
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             5e5),
           ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5))
    _close(common.rope_freqs(128, 1e4), ref_common.rope_freqs(128, 1e4))
    h = rng.standard_normal((2, 5, 96)).astype(np.float32)
    scale = rng.standard_normal(96).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(h), torch.from_numpy(scale)),
           ref_common.rms_norm(jnp.asarray(h), jnp.asarray(scale)))


def test_generate_greedy_on_cpu():
    res = serve.serve_lm("smollm-360m", 2, 12, 4, device="cpu")
    assert res["tokens"].shape == (2, 4) and res["decode_steps"] == 3
    cfg = get_smoke("smollm-360m")
    assert int(res["tokens"].max()) < cfg.vocab


def test_unported_lm_parts_raise(tmp_path):
    with pytest.raises(KeyError, match="Queue 1 item 8"):
        get_config("phi3.5-moe-42b-a6.6b")
    with pytest.raises(KeyError, match="Queue 1 item 8"):
        get_smoke("moonshot-v1-16b-a3b")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        Trainer("tinyllama-1.1b", device="cpu", ckpt_dir=str(tmp_path))
    moe = dataclasses.replace(get_smoke("llama3-8b"),
                              moe=MoESpec(n_experts=4, top_k=2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        api.build_cell(moe, "train_4k", device="cpu")
    cfg = dataclasses.replace(get_smoke("llama3-8b"), kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        transformer.init_cache(cfg, 1, 8, "cpu")


def test_convert_refuses_bad_lm_trees():
    _, _, tp = _params("llama3-8b")
    tree = {k: v.numpy() for k, v in tp.items() if k != "layers"}
    layers = {k: v.numpy() for k, v in tp["layers"].items()}
    with pytest.raises(KeyError):               # an MoE tree
        params_from_arrays("lm", {**tree, "layers": {
            **layers, "router": np.zeros((2, 4, 8), np.float32)}}, "cpu")
    with pytest.raises(KeyError):
        params_from_arrays("lm", {"embed": tree["embed"],
                                  "layers": layers}, "cpu")
    with pytest.raises(KeyError):
        params_from_arrays("lm", tree, "cpu")   # no layers
    got = params_from_arrays("lm", {**tree, "layers": layers}, "cpu")
    assert set(got) == {"embed", "final_norm", "lm_head", "layers"}
