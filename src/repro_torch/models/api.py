"""Uniform step contract for the (architecture × shape) cells the port
serves.

``build_cell(cfg, shape_name, device)`` returns a CellSpec with

    step(state, batch) -> (state, out)

over tensors on the cell's device, plus the batch's shapes and dtypes.
Kinds: serve and retrieval (recsys), train, prefill and decode (the dense
LMs). The LM train step accumulates float32 gradients over
``cfg.microbatches`` microbatches, then takes one AdamW step in place.
The recsys ``train`` kind and the GNN's cells are not ported (ROADMAP.md,
Queue 1 item 8) and raise ``NotImplementedError``; the GNN dense-batch
forward is reached through ``models.gnn.forward_dense``.
Unlike the reference there is no mesh and no sharding: a cell runs on one
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import LMConfig, RecsysConfig, shapes_for_family
from ..core.query_torch import resolve_device
from ..optim.optimizer import OptConfig, adamw_init, adamw_update
from . import recsys as rec_mod
from . import transformer as tf_mod

PAD_UNIT = 512  # the reference's padding unit for data-parallel dims


def _pad(x: int, unit: int = PAD_UNIT) -> int:
    return -(-x // unit) * unit


@dataclass
class CellSpec:
    arch: str
    shape_name: str
    kind: str
    step: Callable                       # (state, batch) -> (state, out)
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    device: torch.device
    shape: Any = None


_NOT_PORTED = ("{what} is not ported to repro_torch yet (ROADMAP.md, "
               "Queue 1 item 8: training of the recsys and GNN families)")


def _recsys_cell(cfg: RecsysConfig, shape, opt_cfg: OptConfig):
    Lh = cfg.hist_len
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "serve":
        B = shape.batch
        batch_shapes = {"hist_ids": ((B, Lh), i32),
                        "hist_mask": ((B, Lh), f32)}

        def step(state, batch):
            caps = rec_mod.serve_interests(cfg, state["params"],
                                           batch["hist_ids"],
                                           batch["hist_mask"])
            return state, caps

        return step, batch_shapes

    if shape.kind == "retrieval":
        C = _pad(shape.n_candidates)
        batch_shapes = {"hist_ids": ((1, Lh), i32),
                        "hist_mask": ((1, Lh), f32),
                        "cand_ids": ((C,), i32)}

        def step(state, batch):
            caps = rec_mod.serve_interests(cfg, state["params"],
                                           batch["hist_ids"],
                                           batch["hist_mask"])
            scores = rec_mod.retrieval_scores(cfg, state["params"], caps[0],
                                              batch["cand_ids"])
            return state, scores

        return step, batch_shapes
    raise NotImplementedError(
        _NOT_PORTED.format(what=f"the recsys {shape.kind!r} cell"))


def _lm_grads(cfg: LMConfig, params, tokens, labels, loss_chunk):
    """(float32 loss, grads) of one batch: the grads in the params'
    dtypes, in ``params``'s tree with each stacked layer leaf replaced by
    the list of its per-layer gradients (``transformer.layer_leaves``)."""
    leaves = tf_mod.layer_leaves(params)
    loss = tf_mod.logits_and_loss(cfg, leaves, tokens, labels, loss_chunk)
    top = [name for name in leaves if name != "layers"]
    names = tf_mod.LAYER_LEAVES
    flat = [leaves[name] for name in top] + [
        lp[name] for lp in leaves["layers"] for name in names]
    g = iter(torch.autograd.grad(loss, flat))
    tree = {name: next(g) for name in top}
    per_layer = [{name: next(g) for name in names} for _ in leaves["layers"]]
    tree["layers"] = {name: [lp[name] for lp in per_layer] for name in names}
    return loss.detach(), tree


def _lm_train_step(cfg: LMConfig, opt_cfg: OptConfig, B: int,
                   loss_chunk: int = 16384):
    mb = max(1, cfg.microbatches)
    if B % mb:
        raise ValueError(f"batch {B} does not split into {mb} microbatches")

    def step(state, batch):
        params = state["params"]
        if mb == 1:
            loss, g = _lm_grads(cfg, params, batch["tokens"],
                                batch["labels"], loss_chunk)
            grads = {k: v for k, v in g.items() if k != "layers"}
            grads["layers"] = {k: torch.stack(v)
                               for k, v in g["layers"].items()}
        else:
            # gradient accumulation in float32, microbatch by microbatch
            grads = {k: torch.zeros_like(v, dtype=torch.float32)
                     for k, v in params.items() if k != "layers"}
            grads["layers"] = {k: torch.zeros_like(v, dtype=torch.float32)
                               for k, v in params["layers"].items()}
            losses = []
            for toks, labs in zip(batch["tokens"].chunk(mb),
                                  batch["labels"].chunk(mb)):
                loss, g = _lm_grads(cfg, params, toks, labs, loss_chunk)
                losses.append(loss)
                for k, v in g.items():
                    if k != "layers":
                        grads[k].add_(v)
                for k, per_layer in g["layers"].items():
                    for i, v in enumerate(per_layer):
                        grads["layers"][k][i].add_(v)
                del g
            for leaf in [*(v for k, v in grads.items() if k != "layers"),
                         *grads["layers"].values()]:
                leaf.div_(mb)
            loss = torch.stack(losses).mean()
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"])
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return step


def _lm_cell(cfg: LMConfig, shape, opt_cfg: OptConfig):
    tf_mod.dense_only(cfg)
    B, S = shape.batch, shape.seq_len
    i32 = torch.int32

    if shape.kind == "train":
        batch_shapes = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
        return _lm_train_step(cfg, opt_cfg, B), batch_shapes

    if shape.kind == "prefill":
        batch_shapes = {"tokens": ((B, S), i32)}

        def step(state, batch):
            logits, cache = tf_mod.prefill(cfg, state["params"],
                                           batch["tokens"], S)
            return state, {"logits": logits, "cache": cache}

        return step, batch_shapes

    if shape.kind == "decode":
        batch_shapes = {"token": ((B, 1), i32), "pos": ((), i32)}

        def step(state, batch):
            # the cache is updated in place (transformer.decode_step)
            logits, cache = tf_mod.decode_step(
                cfg, state["params"], state["cache"], batch["token"],
                batch["pos"])
            return {"params": state["params"], "cache": cache}, logits

        return step, batch_shapes
    raise NotImplementedError(
        _NOT_PORTED.format(what=f"the LM {shape.kind!r} cell"))


_CELLS = {"recsys": _recsys_cell, "lm": _lm_cell}


def build_cell(cfg, shape_name: str, device="cuda", shape_override=None,
               opt_cfg: OptConfig | None = None) -> CellSpec:
    shape = shape_override or shapes_for_family(cfg.family)[shape_name]
    if cfg.family not in _CELLS:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"the {cfg.family} {shape.kind!r} cell"))
    dev = resolve_device(device)
    step, batch_shapes = _CELLS[cfg.family](cfg, shape,
                                            opt_cfg or OptConfig())
    return CellSpec(arch=cfg.arch_id, shape_name=shape_name, kind=shape.kind,
                    step=step, batch_shapes=batch_shapes, device=dev,
                    shape=shape)


def materialize_state(cell: CellSpec, cfg, shape_name: str,
                      gen: torch.Generator):
    """Real (allocated) state on the cell's device, drawn from ``gen`` (a
    generator on that device)."""
    if cfg.family == "recsys":
        return {"params": rec_mod.init_params(cfg, gen, cell.device)}
    if cfg.family == "lm":
        state = {"params": tf_mod.init_params(cfg, gen, cell.device)}
        if cell.kind == "train":
            state["opt"] = adamw_init(state["params"])
        if cell.kind == "decode":
            state["cache"] = tf_mod.init_cache(cfg, cell.shape.batch,
                                               cell.shape.seq_len,
                                               cell.device)
        return state
    raise NotImplementedError(_NOT_PORTED.format(
        what=f"state for the {cfg.family} family"))
