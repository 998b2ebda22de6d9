"""The port's LM training path on the CPU against the JAX package: the
optimizer (``adamw_update``, ``clip_by_global_norm``, ``schedule_lr``),
``TokenPipeline``, ``logits_and_loss`` and its gradients, the LM
``train_4k`` cell over two steps and resumed from a carried-across
state, and the ``Trainer``. Params come from the reference's
``init_params`` through ``models.convert``; data from numpy seeds.

Tolerances: the optimizer at rtol 1e-5, atol 1e-6 (the same float32
arithmetic); the loss, grad_norm and lr at rtol 1e-4, each gradient, m
and v at rtol 1e-4 and atol 1e-5 × the leaf's largest magnitude (float32
layers of matmuls, softmax and norms summed in another order); updated
params at atol 2·lr (at step 1 Adam's m̂/√v̂ is ±1, and an element whose
gradient is within rounding of 0 may take the other sign).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as ref_get_smoke
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.models import api as ref_api
from repro.models import transformer as ref_tf
from repro.optim import optimizer as ref_opt
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.data import TokenPipeline
from repro_torch.launch import train
from repro_torch.launch.train import Trainer
from repro_torch.models import api, transformer
from repro_torch.models.convert import params_from_arrays, state_from_arrays
from repro_torch.optim import optimizer as opt

pytestmark = pytest.mark.arch

LM_ARCHS = ("llama3-8b", "tinyllama-1.1b", "smollm-360m")
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=1e-4, atol=1e-5 * top, err_msg=what)


def _pairs(got, want, prefix=""):
    """(path, port leaf, reference leaf) over the reference tree's keys."""
    for key in sorted(want):
        if isinstance(want[key], dict):
            yield from _pairs(got[key], want[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", got[key], want[key]


# ---------------------------------------------------------- optimizer ----
def _tree(seed, bf16=True):
    """A random params tree: stacked [L, D] norms (decayed: ndim 2), a 1-d
    bias, float32 and bfloat16 matrices."""
    rng = np.random.default_rng(seed)
    tree = {"norm": rng.standard_normal((3, 8)).astype(np.float32),
            "bias": rng.standard_normal(5).astype(np.float32),
            "w": rng.standard_normal((3, 6, 4)).astype(np.float32),
            "emb": rng.standard_normal((7, 6)).astype(np.float32)}
    dt = {k: (jnp.bfloat16 if bf16 and k in ("w", "emb") else jnp.float32)
          for k in tree}
    return {k: jnp.asarray(v, dt[k]) for k, v in tree.items()}


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in tree.items()}


@pytest.mark.parametrize("schedule", ["cosine", "constant", "linear"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    cfg, ref_cfg = opt.OptConfig(**kw), ref_opt.OptConfig(**kw)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        got = opt.schedule_lr(cfg, torch.tensor(step, dtype=torch.int32))
        want = ref_opt.schedule_lr(ref_cfg, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **OPT_TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(1)
    want, want_norm = ref_opt.clip_by_global_norm(tree, max_norm)
    got, got_norm = opt.clip_by_global_norm(_to_torch(tree), max_norm)
    np.testing.assert_allclose(float(got_norm), float(want_norm), **OPT_TOL)
    for key in tree:
        assert got[key].dtype == _to_torch(tree)[key].dtype
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   **OPT_TOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_reference(bf16):
    """Three steps from random params and grads: the moments float32,
    the decay on every leaf with ndim >= 2 (the stacked norms too)."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
                  grad_clip=1.0)
    cfg, ref_cfg = opt.OptConfig(**cfg_kw), ref_opt.OptConfig(**cfg_kw)
    params = _tree(2, bf16)
    state = ref_opt.adamw_init(params)
    tparams = _to_torch(params)
    tstate = opt.adamw_init(tparams)
    for step in range(3):
        grads = _tree(10 + step, bf16)
        params, state, metrics = ref_opt.adamw_update(ref_cfg, params, grads,
                                                      state)
        tparams, tstate, tmetrics = opt.adamw_update(cfg, tparams,
                                                     _to_torch(grads), tstate)
        assert int(tstate["step"]) == int(state["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmetrics[key]),
                                       float(metrics[key]), **OPT_TOL)
        for key in params:
            for got, want in ((tstate["m"][key], state["m"][key]),
                              (tstate["v"][key], state["v"][key])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           **OPT_TOL)
            assert tparams[key].dtype == _to_torch(params)[key].dtype
            np.testing.assert_allclose(tparams[key].float().numpy(),
                                       np.asarray(params[key], np.float32),
                                       **OPT_TOL)


def test_weight_decay_reaches_stacked_norms_only_by_ndim():
    cfg = opt.OptConfig(lr=1e-2, weight_decay=0.5, grad_clip=1e9,
                        warmup_steps=0, schedule="constant")
    p = {"stacked_norm": torch.ones((2, 4)), "norm": torch.ones(4)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    opt.adamw_update(cfg, p, g, opt.adamw_init(p))
    assert float((p["stacked_norm"] - 1.0).abs().max()) > 1e-4    # decayed
    torch.testing.assert_close(p["norm"], torch.ones(4))


# -------------------------------------------------------------- data ----
@pytest.mark.parametrize("seed,step,workers,worker", [
    (0, 0, 1, 0), (3, 7, 1, 0), (5, 2, 2, 1), (11, 100, 4, 3)])
def test_token_pipeline_matches_reference(seed, step, workers, worker):
    kw = dict(vocab=997, batch=8, seq_len=33, seed=seed, n_workers=workers,
              worker=worker)
    for got, want in zip(TokenPipeline(**kw).batch_at(step),
                         RefPipeline(**kw).batch_at(step)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    resumed = TokenPipeline.resume(997, 8, 33, TokenPipeline(**kw).state(step),
                                   worker=worker)
    np.testing.assert_array_equal(resumed.batch_at(step)[0],
                                  RefPipeline(**kw).batch_at(step)[0])


# -------------------------------------------------------------- loss ----
def _loss_inputs(arch, seed):
    cfg = ref_get_smoke(arch)
    p = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    toks, labs = RefPipeline(cfg.vocab, 2, 24, seed=seed).batch_at(0)
    return cfg, p, toks, labs


def _port_loss_and_grads(cfg, p, toks, labs, chunk):
    tp = params_from_arrays("lm", _np(p), "cpu")
    leaves = [tp["embed"], tp["final_norm"], tp["lm_head"],
              *tp["layers"].values()]
    for t in leaves:
        t.requires_grad_()
    loss = transformer.logits_and_loss(cfg, tp, torch.from_numpy(toks),
                                       torch.from_numpy(labs), chunk)
    loss.backward()
    return loss, tp


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logits_and_loss_and_grads_match_reference(arch):
    """loss_chunk 20 does not divide B·S = 48: three chunks, the last
    padded with weight 0."""
    cfg, p, toks, labs = _loss_inputs(arch, 4)
    want, want_g = jax.value_and_grad(
        lambda pp: ref_tf.logits_and_loss(cfg, pp, jnp.asarray(toks),
                                          jnp.asarray(labs), loss_chunk=20)
    )(p)
    loss, tp = _port_loss_and_grads(get_smoke(arch), p, toks, labs, 20)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    for path, got, w in _pairs(tp, _np(want_g)):
        _leaf_close(got.grad, w, path)


def test_remat_gives_the_same_numbers():
    """cfg.remat checkpoints every layer: the backward recomputes each
    layer, with the same loss and gradients as without."""
    arch = "tinyllama-1.1b"
    cfg, p, toks, labs = _loss_inputs(arch, 5)
    plain_cfg = get_smoke(arch)
    assert not plain_cfg.remat
    base, tp = _port_loss_and_grads(plain_cfg, p, toks, labs, 16384)
    remat, tr = _port_loss_and_grads(
        dataclasses.replace(plain_cfg, remat=True), p, toks, labs, 16384)
    torch.testing.assert_close(remat, base, rtol=1e-6, atol=0)
    for (path, a, _), (_, b, _) in zip(_pairs(tr, _np(p)), _pairs(tp, _np(p))):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7,
                                   msg=path)


def test_layer_leaves_give_per_layer_grads():
    """layer_leaves splits the stacked leaves into per-layer views: the
    gradients of the views stacked equal those of the stacked leaves."""
    arch = "smollm-360m"
    cfg, p, toks, labs = _loss_inputs(arch, 6)
    pcfg = get_smoke(arch)
    _, tp = _port_loss_and_grads(pcfg, p, toks, labs, 16384)
    leaves = transformer.layer_leaves(params_from_arrays("lm", _np(p), "cpu"))
    assert len(leaves["layers"]) == pcfg.n_layers
    loss = transformer.logits_and_loss(pcfg, leaves, torch.from_numpy(toks),
                                       torch.from_numpy(labs))
    loss.backward()
    for name, stacked in tp["layers"].items():
        got = torch.stack([lp[name].grad for lp in leaves["layers"]])
        torch.testing.assert_close(got, stacked.grad, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(leaves["embed"].grad, tp["embed"].grad,
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------- train cell ----
def _train_cells(arch, b=8, s=16):
    cfg, pcfg = ref_get_smoke(arch), get_smoke(arch)
    assert cfg.microbatches == pcfg.microbatches == 4
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=b,
                              seq_len=s)
    kw = dict(warmup_steps=10, total_steps=100)
    ref_cell = ref_api.build_cell(cfg, "train_4k", shape_override=shp,
                                  opt_cfg=ref_opt.OptConfig(**kw))
    cell = api.build_cell(pcfg, "train_4k", device="cpu", shape_override=shp,
                          opt_cfg=opt.OptConfig(**kw))
    batches = [RefPipeline(cfg.vocab, b, s, seed=7).batch_at(i)
               for i in range(2)]
    return cfg, ref_cell, cell, batches


def _hold_state(tstate, state, metrics, tmetrics):
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmetrics[key]), float(metrics[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    lr = float(metrics["lr"])
    for path, got, want in _pairs(tstate["params"], _np(state["params"])):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 * lr, err_msg=path)
    for name in ("m", "v"):
        for path, got, want in _pairs(tstate["opt"][name],
                                      _np(state["opt"][name])):
            _leaf_close(got, want, f"{name}/{path}")
    assert int(tstate["opt"]["step"]) == int(state["opt"]["step"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_cell_two_steps_match_reference(arch):
    cfg, ref_cell, cell, batches = _train_cells(arch)
    assert cell.kind == "train"
    for key, (shape, dtype) in cell.batch_shapes.items():
        assert tuple(shape) == tuple(ref_cell.batch_sds[key].shape)
        assert dtype == torch.int32
    state = ref_api.materialize_state(ref_cell, cfg, "train_4k",
                                      jax.random.PRNGKey(2))
    tstate = state_from_arrays("lm", _np(state), "cpu")
    step = jax.jit(ref_cell.step)
    for toks, labs in batches:
        state, metrics = step(state, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labs)})
        tstate, tmetrics = cell.step(tstate, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labs)})
        _hold_state(tstate, state, metrics, tmetrics)


def test_train_cell_resumes_from_a_reference_state():
    """Both packages resume from the reference's step-1 state, carried
    across whole (params, m, v, step), and agree on step 2."""
    arch = "tinyllama-1.1b"
    cfg, ref_cell, cell, batches = _train_cells(arch)
    state = ref_api.materialize_state(ref_cell, cfg, "train_4k",
                                      jax.random.PRNGKey(3))
    step = jax.jit(ref_cell.step)
    toks, labs = batches[0]
    state, _ = step(state, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labs)})
    tstate = state_from_arrays("lm", _np(state), "cpu")
    assert int(tstate["opt"]["step"]) == 1
    toks, labs = batches[1]
    state, metrics = step(state, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labs)})
    tstate, tmetrics = cell.step(tstate, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labs)})
    _hold_state(tstate, state, metrics, tmetrics)


def test_materialize_train_state_matches_reference_tree():
    arch = "smollm-360m"
    cfg, ref_cell, cell, _ = _train_cells(arch)
    want = ref_api.materialize_state(ref_cell, cfg, "train_4k",
                                     jax.random.PRNGKey(0))
    got = api.materialize_state(cell, get_smoke(arch), "train_4k",
                                torch.Generator().manual_seed(0))
    assert set(got) == set(want) == {"params", "opt"}
    for name in ("m", "v"):
        for path, g, w in _pairs(got["opt"][name], _np(want["opt"][name])):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
            assert not g.any(), path
    assert int(got["opt"]["step"]) == 0


def test_state_from_arrays_refuses_bad_states():
    cfg = ref_get_smoke("llama3-8b")
    p = _np(ref_tf.init_params(cfg, jax.random.PRNGKey(0)))
    o = _np(ref_opt.adamw_init(p))
    with pytest.raises(KeyError, match="unexpected"):
        state_from_arrays("lm", {"params": p, "cache": {}}, "cpu")
    with pytest.raises(KeyError, match="opt state"):
        state_from_arrays("lm", {"params": p, "opt": {"m": o["m"]}}, "cpu")
    half = {**o, "m": jax.tree.map(lambda a: a.astype(np.float16), o["m"])}
    with pytest.raises(TypeError, match="float32"):
        state_from_arrays("lm", {"params": p, "opt": half}, "cpu")
    only = state_from_arrays("lm", {"params": p}, "cpu")
    assert set(only) == {"params"}


# ------------------------------------------------------------ trainer ----
def test_trainer_three_steps_on_cpu():
    tr = Trainer("tinyllama-1.1b", device="cpu", batch_override=8,
                 seq_override=32, seed=1)
    assert tr.cfg == get_smoke("tinyllama-1.1b")
    assert tr.opt_cfg.warmup_steps == 10
    tr.init_state()
    before = {k: v.clone() for k, v in tr.state["params"]["layers"].items()}
    hist = tr.run(3)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["seconds"] > 0 for h in hist)
    assert np.isfinite(tr.metrics["grad_norm"]) and tr.metrics["lr"] > 0
    changed = [k for k, v in tr.state["params"]["layers"].items()
               if not torch.equal(v, before[k])]
    assert sorted(changed) == sorted(before)
    assert int(tr.state["opt"]["step"]) == 3


def test_train_cli_on_cpu(capsys):
    hist = train.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                       "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 2 and "2 layers" in out and "done: 2 steps" in out
