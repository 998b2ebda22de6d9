"""The port's MIND recsys serving path on the CPU against the JAX package:
kernel 10's plain version against the reference's Pallas
``retrieval_score`` (interpret mode) at the reference tests' sweep
shapes, the capsule routing (``interests``), ``retrieval_scores`` with the
reference's Pallas kernel, and the ``serve`` and ``retrieval`` cells
through both packages' ``build_cell`` at the SMOKE config; training:
``label_aware_user_vec`` and the sampled-softmax ``train_loss`` with
their gradients against ``jax.value_and_grad``, and two steps of the
``train`` cell against the reference's jitted step. The params
come from the reference's ``init_params`` and cross over through
``models.convert.params_from_arrays``; the inputs are numpy, from a seed.

Tolerances: rtol 1e-5, atol 1e-5 for the kernel (float32 dot products of
at most 64 terms, summed in another order); rtol 1e-4, atol 1e-5 for
capsule routing and the cells (three routing rounds of softmax, einsums
and squash, each rounding in its own order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import shapes_for_family
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.kernels.retrieval_score import retrieval_score as ref_kernel
from repro.models import api as ref_api
from repro.models import recsys as ref_rec
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import \
    shapes_for_family as port_shapes_for_family
from repro_torch.kernels import _lib, ops
from repro_torch.kernels.retrieval_score import (retrieval_score,
                                                 retrieval_score_plain)
from repro_torch.models import api, recsys
from repro_torch.models.convert import params_from_arrays, state_from_arrays

pytestmark = pytest.mark.arch

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)


def _params(cfg, seed=0):
    p = ref_rec.init_params(cfg, jax.random.PRNGKey(seed))
    return p, params_from_arrays("recsys", jax.tree.map(np.asarray, p),
                                 "cpu")


def _history(rng, cfg, b):
    ids = rng.integers(0, cfg.n_items, (b, cfg.hist_len)).astype(np.int32)
    mask = (rng.random((b, cfg.hist_len)) < 0.9).astype(np.float32)
    mask[0] = 0.0                     # a user with no history at all
    mask[1, 1:] = 0.0                 # and one with a single item
    return ids, mask


@pytest.mark.parametrize("c,d,i,block_c", [
    (100, 16, 4, 64), (5000, 64, 4, 2048), (2048, 32, 8, 512),
    (1, 64, 4, 128),
])
def test_plain_matches_reference_kernel(c, d, i, block_c):
    rng = np.random.default_rng(c + d + i)
    cands = rng.standard_normal((c, d)).astype(np.float32)
    ints = rng.standard_normal((i, d)).astype(np.float32)
    want = ref_kernel(jnp.asarray(cands), jnp.asarray(ints),
                      block_c=block_c, interpret=True)
    got = retrieval_score_plain(torch.from_numpy(cands),
                                torch.from_numpy(ints))
    assert got.shape == (c,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    rng = np.random.default_rng(3)
    cands = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    ints = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    before = dict(_lib.LAUNCHES)
    np.testing.assert_array_equal(retrieval_score(cands, ints).numpy(),
                                  retrieval_score_plain(cands, ints).numpy())
    assert ops.retrieval_score is retrieval_score
    assert retrieval_score(cands[:0], ints).shape == (0,)
    assert dict(_lib.LAUNCHES) == before


def test_interests_match_reference():
    cfg = ref_get_smoke("mind")
    p, tp = _params(cfg)
    ids, mask = _history(np.random.default_rng(0), cfg, 32)
    want = ref_rec.interests(cfg, p, jnp.asarray(ids), jnp.asarray(mask))
    got = recsys.interests(get_smoke("mind"), tp, torch.from_numpy(ids),
                           torch.from_numpy(mask))
    assert got.shape == (32, cfg.n_interests, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)


def test_retrieval_scores_match_reference_pallas():
    cfg = ref_get_smoke("mind")
    p, tp = _params(cfg, seed=1)
    rng = np.random.default_rng(1)
    ids, mask = _history(rng, cfg, 4)
    caps = np.array(ref_rec.interests(cfg, p, jnp.asarray(ids),
                                      jnp.asarray(mask)))[2]
    cand = rng.integers(0, cfg.n_items, 3000).astype(np.int32)
    want = ref_rec.retrieval_scores(cfg, p, jnp.asarray(caps),
                                    jnp.asarray(cand), use_pallas=True)
    got = recsys.retrieval_scores(get_smoke("mind"), tp,
                                  torch.from_numpy(caps),
                                  torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def _tiny(shape_name):
    shp = shapes_for_family("recsys")[shape_name]
    return dataclasses.replace(shp, batch=16, n_candidates=512)


@pytest.mark.parametrize("shape_name", ["serve_p99", "serve_bulk",
                                        "retrieval_cand"])
def test_cell_matches_reference(shape_name):
    cfg = ref_get_smoke("mind")
    shp = _tiny(shape_name)
    ref_cell = ref_api.build_cell(cfg, shape_name, shape_override=shp)
    state = ref_api.materialize_state(ref_cell, cfg, shape_name,
                                      jax.random.PRNGKey(2))
    cell = api.build_cell(get_smoke("mind"), shape_name, device="cpu",
                          shape_override=shp)
    assert cell.kind == ref_cell.kind and cell.device.type == "cpu"
    rng = np.random.default_rng(5)
    batch = {}
    for name, (shape, dtype) in cell.batch_shapes.items():
        ref_sds = ref_cell.batch_sds[name]
        assert tuple(shape) == tuple(ref_sds.shape)
        assert str(dtype).split(".")[-1] == str(ref_sds.dtype)
        if name == "hist_mask":
            batch[name] = (rng.random(shape) < 0.9).astype(np.float32)
        else:
            batch[name] = rng.integers(0, cfg.n_items, shape).astype(np.int32)
    if shape_name == "retrieval_cand":
        assert cell.batch_shapes["cand_ids"][0] == (api._pad(512),)
    tstate = {"params": params_from_arrays(
        "recsys", jax.tree.map(np.asarray, state["params"]), "cpu")}
    _, want = jax.jit(ref_cell.step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    _, got = cell.step(tstate, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)


def test_materialize_state_shapes_match_reference():
    cfg = ref_get_smoke("mind")
    cell = api.build_cell(get_smoke("mind"), "serve_p99", device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = api.materialize_state(cell, get_smoke("mind"), "serve_p99", gen)
    want = ref_rec.init_params(cfg, jax.random.PRNGKey(0))
    assert set(state["params"]) == set(want)
    for k, v in state["params"].items():
        assert tuple(v.shape) == want[k].shape
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype)
    # the table is D^-1/2 · N(0, 1), as in the reference
    assert abs(float(state["params"]["table"].std())
               - cfg.embed_dim ** -0.5) < 0.01


def test_unported_cells_and_archs_raise():
    """What is refused: an unknown arch, and a mesh this rank is not in
    (every cell takes a mesh; ``tests/test_torch_sharded_cells_*.py``).
    The MoE configs' train cell builds."""
    from types import SimpleNamespace
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("phi3.5-moe")
    moe = get_smoke("phi3.5-moe-42b-a6.6b")
    assert api.build_cell(moe, "train_4k", device="cpu").kind == "train"
    assert api.build_cell(moe, "decode_32k", device="cpu").kind == "decode"
    with pytest.raises(ValueError, match="not in"):
        api.build_cell(get_smoke("gin-tu"), "molecule", device="cpu",
                       mesh=SimpleNamespace(member=False, rank=3))


# ----------------------------------------------------------- training ----
def _train_batch(rng, cfg, b):
    ids, mask = _history(rng, cfg, b)
    return {"hist_ids": ids, "hist_mask": mask,
            "target": rng.integers(0, cfg.n_items, b).astype(np.int32),
            "negatives": rng.integers(0, cfg.n_items,
                                      (b, cfg.n_negatives)).astype(np.int32)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_label_aware_user_vec_and_grads_match_reference():
    rng = np.random.default_rng(11)
    caps = rng.standard_normal((8, 4, 16)).astype(np.float32)
    tgt = rng.standard_normal((8, 16)).astype(np.float32)
    tgt[0] = 0.0              # every affinity 0: all at the 1e-9 floor
    caps[1, 2] = 0.0          # one interest of zero affinity

    def f(c, t):
        return jnp.sum(jnp.sin(ref_rec.label_aware_user_vec(c, t)))

    want, (wc, wt) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(caps), jnp.asarray(tgt))
    c = torch.from_numpy(caps).requires_grad_()
    t = torch.from_numpy(tgt).requires_grad_()
    got = torch.sum(torch.sin(recsys.label_aware_user_vec(c, t)))
    gc, gt = torch.autograd.grad(got, (c, t))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               **FORWARD_TOL)
    for g, w in ((gc, wc), (gt, wt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FORWARD_TOL)


def test_train_loss_and_grads_match_reference():
    cfg = ref_get_smoke("mind")
    p, tp = _params(cfg, seed=3)
    batch = _train_batch(np.random.default_rng(12), cfg, 32)
    want, wgrads = jax.value_and_grad(
        lambda q: ref_rec.train_loss(cfg, q, _jax_batch(batch)))(p)
    loss, grads = api.value_and_grad(
        lambda q: recsys.train_loss(get_smoke("mind"), q,
                                    _torch_batch(batch)), tp)
    np.testing.assert_allclose(float(loss), float(want), **FORWARD_TOL)
    assert set(grads) == set(wgrads)
    for k, w in wgrads.items():
        w = np.asarray(w)
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


def test_recsys_train_cell_two_steps_match_reference():
    cfg, pcfg = ref_get_smoke("mind"), get_smoke("mind")
    shp = dataclasses.replace(shapes_for_family("recsys")["train_batch"],
                              batch=64)
    pshp = dataclasses.replace(port_shapes_for_family("recsys")[
        "train_batch"], batch=64)
    ref_cell = ref_api.build_cell(cfg, "train_batch", shape_override=shp)
    cell = api.build_cell(pcfg, "train_batch", device="cpu",
                          shape_override=pshp)
    assert cell.kind == "train"
    for key, (shape, dtype) in cell.batch_shapes.items():
        assert tuple(shape) == tuple(ref_cell.batch_sds[key].shape), key
        assert str(dtype).split(".")[-1] == str(ref_cell.batch_sds[key].dtype)
    assert cell.model_flops_fn() == ref_cell.model_flops_fn()
    state = ref_api.materialize_state(ref_cell, cfg, "train_batch",
                                      jax.random.PRNGKey(4))
    tstate = state_from_arrays("recsys", jax.tree.map(np.asarray, state),
                               "cpu")
    step = jax.jit(ref_cell.step)
    rng = np.random.default_rng(13)
    for _ in range(2):
        batch = _train_batch(rng, cfg, 64)
        state, metrics = step(state, _jax_batch(batch))
        tstate, tmetrics = cell.step(tstate, _torch_batch(batch))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmetrics[key]),
                                       float(metrics[key]), rtol=1e-4,
                                       err_msg=key)
        for k, w in state["params"].items():
            np.testing.assert_allclose(tstate["params"][k].numpy(),
                                       np.asarray(w), **FORWARD_TOL,
                                       err_msg=k)
        for name in ("m", "v"):
            for k, w in state["opt"][name].items():
                np.testing.assert_allclose(tstate["opt"][name][k].numpy(),
                                           np.asarray(w), **FORWARD_TOL,
                                           err_msg=f"{name}/{k}")
    assert int(tstate["opt"]["step"]) == 2


def test_materialize_recsys_train_state_has_opt():
    cell = api.build_cell(get_smoke("mind"), "train_batch", device="cpu")
    state = api.materialize_state(cell, get_smoke("mind"), "train_batch",
                                  torch.Generator().manual_seed(0))
    assert set(state) == {"params", "opt"}
    assert set(state["opt"]["m"]) == set(state["params"])
    assert int(state["opt"]["step"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies_of_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        ref_get_config(arch))
    assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(
        ref_get_smoke(arch))
    fam = get_config(arch).family
    assert ({k: dataclasses.asdict(v) for k, v in
             port_shapes_for_family(fam).items()}
            == {k: dataclasses.asdict(v) for k, v in
                shapes_for_family(fam).items()})


def test_cell_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_cell(get_smoke("mind"), "serve_p99")
