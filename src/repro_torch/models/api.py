"""Uniform step contract for the (architecture × shape) cells the port
serves.

``build_cell(cfg, shape_name, device)`` returns a CellSpec with

    step(state, batch) -> (state, out)

over tensors on the cell's device, plus the batch's shapes and dtypes.
Kinds: serve and retrieval (recsys), prefill and decode (the dense LMs).
The kinds that train (recsys ``train``, the GNN's cells, LM ``train``)
wait for the training slice (ROADMAP.md, Queue 1 item 8) and raise
``NotImplementedError``; the GNN dense-batch forward is reached through
``models.gnn.forward_dense``.
Unlike the reference there is no mesh and no sharding: a cell runs on one
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import LMConfig, RecsysConfig, shapes_for_family
from ..core.query_torch import resolve_device
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
               "Queue 1 item 8: training of the recsys and GNN families, "
               "and the LM)")


def _recsys_cell(cfg: RecsysConfig, shape):
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


def _lm_cell(cfg: LMConfig, shape):
    B, S = shape.batch, shape.seq_len
    i32 = torch.int32

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


def build_cell(cfg, shape_name: str, device="cuda",
               shape_override=None) -> CellSpec:
    shape = shape_override or shapes_for_family(cfg.family)[shape_name]
    if cfg.family not in _CELLS:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"the {cfg.family} {shape.kind!r} cell"))
    dev = resolve_device(device)
    step, batch_shapes = _CELLS[cfg.family](cfg, shape)
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
        if cell.kind == "decode":
            state["cache"] = tf_mod.init_cache(cfg, cell.shape.batch,
                                               cell.shape.seq_len,
                                               cell.device)
        return state
    raise NotImplementedError(_NOT_PORTED.format(
        what=f"state for the {cfg.family} family"))
