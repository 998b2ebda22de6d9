"""The port's MoE training on one device, on the CPU against the JAX
package, at the SMOKE configs of moonshot-v1-16b-a3b (8 experts, top 2)
and phi3.5-moe-42b-a6.6b (4 experts, top 2), the reference's params
carried across by ``params_from_arrays("lm", ...)``:

- ``logits_and_loss`` and every leaf's gradient (``api._lm_grads``, the
  float32 router's included) against ``jax.grad`` of the reference's,
  with nothing dropped (capacity factor 8) and drop-heavy (0.25, 0.5),
  remat on and off;
- the ``train_4k`` cell's step (1 and 2 microbatches, float32
  accumulation, AdamW) against the reference's jitted cell: loss,
  grad_norm, lr, the params, m and v after it;
- the MoE FFN's two gradient traps (the gates' sentinel slot, the empty
  slots holding token 0), what the combine keeps for its backward, and
  the routing a remat recompute gives;
- an MoE train state's checkpoint read across the two packages both ways,
  and the Trainer's recovery from an injected failure bit for bit.

Tolerances: the loss at rtol 1e-5; each gradient at atol 5e-4 × the
leaf's largest magnitude (the reference's own shard_map gradient test
uses 5e-4); after a step grad_norm and lr at rtol 1e-4, m and v at rtol
1e-4 and atol 5e-4 × max|want|, params at atol 2·lr (at step 1 Adam's
m̂/√v̂ is ±1, and an element whose gradient is within rounding of 0 may
take the other sign).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.launch.train import Trainer as RefTrainer
from repro.models import api as ref_api
from repro.models import transformer as ref_tf
from repro.optim import optimizer as ref_opt
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.launch.train import Trainer
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_arrays, state_from_arrays
from repro_torch.optim import optimizer as opt
from repro_torch.runtime.fault_tolerance import FaultInjector

pytestmark = pytest.mark.arch

MOON, PHI = "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"
LOSS_RTOL = 1e-5
GRAD_ATOL = 5e-4          # times the leaf's largest magnitude
STEP_RTOL = 1e-4
SMALL = dict(batch_override=4, seq_override=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, cf, remat, mb=1):
    """The reference's and the port's SMOKE config of ``arch`` with the
    capacity factor, remat and microbatches of a case."""
    out = []
    for get in (ref_get_smoke, get_smoke):
        cfg = get(arch)
        out.append(dataclasses.replace(
            cfg, remat=remat, microbatches=mb,
            moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))
    return out


def _grad_close(got, want, what):
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=GRAD_ATOL * top, err_msg=what)


def _pairs(got, want, prefix=""):
    for key in sorted(want):
        if isinstance(want[key], dict):
            yield from _pairs(got[key], want[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", got[key], want[key]


def _stacked(g):
    """``_lm_grads``' tree with each per-layer list stacked."""
    return {**{k: v for k, v in g.items() if k != "layers"},
            "layers": {k: torch.stack(v) for k, v in g["layers"].items()}}


# ------------------------------------------------------------- gradients --
GRAD_CASES = [(MOON, 8.0, False), (MOON, 0.25, True), (PHI, 8.0, True),
              (PHI, 0.5, False)]


@pytest.mark.parametrize("arch,cf,remat", GRAD_CASES)
def test_moe_loss_and_grads_match_reference(arch, cf, remat):
    """B·S = 48 rows, loss_chunk 20: three chunks, the last padded."""
    cfg, pcfg = _cfgs(arch, cf, remat)
    p = ref_tf.init_params(cfg, jax.random.PRNGKey(4))
    toks, labs = RefPipeline(cfg.vocab, 2, 24, seed=4).batch_at(0)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda pp: ref_tf.logits_and_loss(cfg, pp, jnp.asarray(toks),
                                          jnp.asarray(labs), loss_chunk=20)
    ))(p)
    tp = params_from_arrays("lm", _np(p), "cpu")
    loss, g = api._lm_grads(pcfg, tp, torch.from_numpy(toks),
                            torch.from_numpy(labs), 20)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    got = _stacked(g)
    assert set(got["layers"]) == set(tf.MOE_LAYER_LEAVES)
    assert got["layers"]["router"].dtype == torch.float32
    for path, a, w in _pairs(got, _np(want_g)):
        _grad_close(a, w, path)


def test_router_gradient_is_present_and_moves_the_router():
    """The per-layer leaves come from the config: an MoE config's include
    the float32 router, whose gradient is non-zero and whose value a
    train step changes."""
    _, pcfg = _cfgs(MOON, 8.0, False)
    tp = tf.init_params(pcfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, pcfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(2))
    _, g = api._lm_grads(pcfg, tp, toks, toks, 16384)
    router = g["layers"]["router"]
    assert len(router) == pcfg.n_layers
    assert all(r.dtype == torch.float32 and bool(r.abs().max() > 0)
               for r in router)
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=2,
                              seq_len=16)
    cell = api.build_cell(pcfg, "train_4k", device="cpu", shape_override=shp)
    state = api.materialize_state(cell, pcfg, "train_4k",
                                  torch.Generator().manual_seed(1))
    before = state["params"]["layers"]["router"].clone()
    state, _ = cell.step(state, {"tokens": toks.int(), "labels": toks.int()})
    after = state["params"]["layers"]["router"]
    assert after.dtype == torch.float32 and not torch.equal(after, before)
    assert state["opt"]["m"]["layers"]["router"].abs().max() > 0


# ------------------------------------------------------------ train cell --
STEP_CASES = [(MOON, 1, 8.0, False), (MOON, 2, 0.25, True),
              (PHI, 2, 8.0, True), (PHI, 1, 0.5, False)]


@pytest.mark.parametrize("arch,mb,cf,remat", STEP_CASES)
def test_moe_train_cell_step_matches_reference(arch, mb, cf, remat):
    cfg, pcfg = _cfgs(arch, cf, remat, mb)
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=4,
                              seq_len=12)
    kw = dict(warmup_steps=10, total_steps=100)
    ref_cell = ref_api.build_cell(cfg, "train_4k", shape_override=shp,
                                  opt_cfg=ref_opt.OptConfig(**kw))
    cell = api.build_cell(pcfg, "train_4k", device="cpu", shape_override=shp,
                          opt_cfg=opt.OptConfig(**kw))
    assert cell.kind == "train" and cell.expert_mesh is None
    state = ref_api.materialize_state(ref_cell, cfg, "train_4k",
                                      jax.random.PRNGKey(2))
    tstate = state_from_arrays("lm", _np(state), "cpu")
    toks, labs = RefPipeline(cfg.vocab, 4, 12, seed=7).batch_at(0)
    state, metrics = jax.jit(ref_cell.step)(
        state, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tstate, tmetrics = cell.step(tstate, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(metrics["loss"]), rtol=LOSS_RTOL)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmetrics[key]), float(metrics[key]),
                                   rtol=STEP_RTOL, err_msg=key)
    lr = float(metrics["lr"])
    for path, got, want in _pairs(tstate["params"], _np(state["params"])):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 * lr, err_msg=path)
    for name in ("m", "v"):
        for path, got, want in _pairs(tstate["opt"][name],
                                      _np(state["opt"][name])):
            top = float(np.abs(want).max())
            np.testing.assert_allclose(got.numpy(), want, rtol=STEP_RTOL,
                                       atol=GRAD_ATOL * top,
                                       err_msg=f"{name}/{path}")
    assert tstate["opt"]["m"]["layers"]["router"].dtype == torch.float32


# ------------------------------------------------------- the FFN's traps --
def _ffn_inputs(arch, cf, g, seed=0):
    _, pcfg = _cfgs(arch, cf, False)
    lp = {k: v[0] for k, v in tf.init_params(
        pcfg, torch.Generator().manual_seed(seed), "cpu")["layers"].items()}
    x = torch.randn(g, pcfg.d_model,
                    generator=torch.Generator().manual_seed(seed + 1))
    return pcfg, lp, x


def test_dropped_gates_take_no_gradient():
    """A dropped assignment's gate goes to the sentinel slot, which is
    cut off the gate table: its gradient is exactly zero, and a kept
    gate's is its slot's."""
    pcfg, lp, x = _ffn_inputs(MOON, 0.25, 32)
    moe = pcfg.moe
    gates, experts = tf.route(moe, lp["router"], x)
    gates = gates.detach().requires_grad_()
    C = tf.capacity(moe, 32)
    _, gate_tbl, slot = tf.dispatch_tables(gates, experts, moe.n_experts, C)
    w = torch.randn(gate_tbl.shape,
                    generator=torch.Generator().manual_seed(5))
    (gate_tbl * w).sum().backward()
    dropped = slot == moe.n_experts * C
    assert 0 < int(dropped.sum()) < slot.numel()
    assert torch.equal(gates.grad[dropped], torch.zeros(int(dropped.sum())))
    flat_w = torch.cat([w.reshape(-1), torch.zeros(1)])
    assert torch.equal(gates.grad[~dropped], flat_w[slot][~dropped])


def test_empty_slots_add_nothing_to_token_zero():
    """An empty slot holds token 0 with gate 0: without token 0's own
    output in the loss, token 0's gradient is exactly zero; with it, the
    same as the gradient through its own K slots alone."""
    pcfg, lp, x = _ffn_inputs(MOON, 8.0, 24)
    C = tf.capacity(pcfg.moe, 24)
    assert C * pcfg.moe.n_experts > 24 * pcfg.moe.top_k   # empty slots
    xg = x.detach().requires_grad_()
    out = tf._moe_ffn(pcfg, lp, xg[None])[0]
    (out[1:] ** 2).sum().backward()
    assert torch.equal(xg.grad[0], torch.zeros(pcfg.d_model))


def test_combine_backward_keeps_only_the_slot_ids():
    """What the combine saves for its backward: the experts' outputs and
    the gates (for each other's gradient, as any product) and the [G, K]
    slot ids; no [E·C, D] copy of the weighted outputs (an ``index_add_``
    combine would keep its source)."""
    pcfg, lp, x = _ffn_inputs(PHI, 8.0, 40)
    moe = pcfg.moe
    gates, experts = tf.route(moe, lp["router"], x)
    C = tf.capacity(moe, 40)
    token_tbl, gate_tbl, slot = tf.dispatch_tables(gates, experts,
                                                   moe.n_experts, C)
    ex_out = tf.expert_ffn(lp, x[token_tbl]).detach().requires_grad_()
    gate_tbl = gate_tbl.detach().requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tf.combine(ex_out, gate_tbl, slot)
    assert out.shape == (40, pcfg.d_model)
    floats = [t for t in saved if t.is_floating_point()]
    ints = [t for t in saved if not t.is_floating_point()]
    assert sum(t.numel() for t in floats) <= ex_out.numel() + gate_tbl.numel()
    assert all(t.numel() <= slot.numel() for t in ints)


def test_remat_recomputes_the_same_routing():
    """With remat each layer's forward runs again in the backward; the
    stable sort routes it the same, so the loss and every gradient equal
    those without remat."""
    arch = MOON
    cfg, _ = _cfgs(arch, 0.5, False)
    p = _np(ref_tf.init_params(cfg, jax.random.PRNGKey(6)))
    toks, labs = (torch.from_numpy(a) for a in
                  RefPipeline(cfg.vocab, 2, 16, seed=6).batch_at(0))
    calls = []
    route = tf.route

    def logged(moe, router, xf):
        gates, experts = route(moe, router, xf)
        calls.append(experts)
        return gates, experts
    out = {}
    tf.route = logged
    try:
        for remat in (False, True):
            _, pcfg = _cfgs(arch, 0.5, remat)
            calls.clear()
            tp = params_from_arrays("lm", p, "cpu")
            out[remat] = api._lm_grads(pcfg, tp, toks, labs, 16384)
            out[remat] = (out[remat], list(calls))
    finally:
        tf.route = route
    (base, plain_calls), (remat, remat_calls) = out[False], out[True]
    L = cfg.n_layers
    assert len(plain_calls) == L and len(remat_calls) == 2 * L
    # the backward recomputes the layers in reverse order
    for i in range(L):
        assert torch.equal(remat_calls[i], plain_calls[i])
        assert torch.equal(remat_calls[2 * L - 1 - i], plain_calls[i])
    assert torch.equal(remat[0], base[0])
    for (path, a, _), (_, b, _) in zip(_pairs(_stacked(remat[1]), p),
                                       _pairs(_stacked(base[1]), p)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=path)


# ----------------------------------------- checkpoints and recovery --
def test_moe_checkpoint_crosses_the_two_packages(tmp_path):
    """An MoE train state (the float32 router and its moments beside the
    expert stacks) written by the port is read by the reference, whose
    Trainer resumes from it; one the reference writes, the port's
    Trainer resumes from, and both take the same next step."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    tr = Trainer(MOON, device="cpu", ckpt_dir=str(port_dir), **SMALL)
    tr.restore_or_init()
    tr.run(2, ckpt_every=1, log_every=100)
    ref = RefTrainer(MOON, smoke=True, **SMALL)
    state, manifest = ref_ckpt.restore_checkpoint(port_dir,
                                                  ref.cell.state_sds)
    assert manifest["step"] == 2
    want = dict(_flatten_with_paths(tr.state))
    paths, leaves, _ = ref_ckpt._flatten_with_paths(state)
    assert sorted(paths) == sorted(want)
    for leaf in ("params/layers/router", "opt/m/layers/router",
                 "opt/v/layers/router"):
        assert want[leaf].dtype == torch.float32 and leaf in paths
    for path, leaf in zip(paths, leaves):
        np.testing.assert_array_equal(np.asarray(leaf), want[path].numpy(),
                                      err_msg=path)

    ref = RefTrainer(MOON, smoke=True, ckpt_dir=str(ref_dir), **SMALL)
    ref.restore_or_init()
    ref.run(2, ckpt_every=2, log_every=100)
    port = Trainer(MOON, device="cpu", ckpt_dir=str(ref_dir), **SMALL)
    assert port.restore_or_init() and port.step_idx == 2
    got = port.run(3, ckpt_every=100, log_every=100)
    want = ref.run(3, ckpt_every=100, log_every=100)
    assert got[-1]["step"] == want[-1]["step"] == 2
    np.testing.assert_allclose(got[-1]["loss"], want[-1]["loss"],
                               rtol=STEP_RTOL)


@pytest.mark.parametrize("arch", [MOON, PHI])
def test_moe_trainer_recovers_to_the_bits_of_an_uninterrupted_run(tmp_path,
                                                                  arch):
    runs = {}
    for name, inj in (("clean", None),
                      ("failed", FaultInjector.worker_failure_at(step=5))):
        tr = Trainer(arch, device="cpu", ckpt_dir=str(tmp_path / name),
                     fault_injector=inj, **SMALL)
        tr.restore_or_init()
        runs[name] = (tr, tr.run(6, ckpt_every=2, log_every=100))
    (clean, clean_hist), (tr, hist) = runs["clean"], runs["failed"]
    assert tr.recoveries == 1 and clean.recoveries == 0
    assert ({h["step"]: h["loss"] for h in hist}
            == {h["step"]: h["loss"] for h in clean_hist})
    for (path, a), (_, b) in zip(_flatten_with_paths(tr.state),
                                 _flatten_with_paths(clean.state)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
