"""Carry a model's parameters, or a whole train state, across from the
reference package.

``params_from_arrays`` takes a params tree as the reference's
``init_params`` builds it, with numpy arrays for leaves (the reference's
arrays through ``np.asarray``), and returns the same tree of tensors on
``device``, checking that every leaf this package's forward reads is
there and no other. ``state_from_arrays`` does the same for a cell's
state, ``{"params", "opt": {"m", "v", "step"}}``. The tests use them to
run both packages on the same weights, or to resume both from one
optimizer state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.query_torch import resolve_device
from .transformer import LAYER_LEAVES, MOE_LAYER_LEAVES

RECSYS_LEAVES = frozenset({"table", "bilinear", "cap_bias"})
LM_LEAVES = frozenset({"embed", "final_norm"})     # and lm_head, untied
GNN_LAYER_LEAVES = {                   # by conv; each layer also has w_self, b
    "gcn": frozenset(),
    "sage": frozenset({"w_neigh"}),
    "gin": frozenset({"w2", "b2", "eps"}),
    "gatedgcn": frozenset({"wA", "wB", "wV"}),
}


def _tensors(tree: dict, want, device, where: str) -> dict:
    if set(tree) != set(want):
        raise KeyError(f"{where}: leaves {sorted(tree)}, expected "
                       f"{sorted(want)}")
    return {k: torch.from_numpy(np.array(v, order="C")).to(device)
            for k, v in tree.items()}


def params_from_arrays(family: str, tree: dict, device="cuda") -> dict:
    """The params tree of ``family`` ("recsys", "gnn" or "lm") as tensors
    on ``device``."""
    dev = resolve_device(device)
    if family == "recsys":
        return _tensors(tree, RECSYS_LEAVES, dev, "recsys params")
    if family == "lm":
        head = {k: v for k, v in tree.items() if k != "layers"}
        want = LM_LEAVES | ({"lm_head"} & set(head))
        layers = tree["layers"]
        moe = "router" in layers
        ffn = {k: np.ndim(layers[k]) for k in ("w_gate", "w_up", "w_down")
               if k in layers}
        if any(nd != (4 if moe else 3) for nd in ffn.values()):
            raise KeyError(f"lm layers: FFN weights of {ffn} dimensions "
                           f"{'beside' if moe else 'without'} a router (an "
                           "MoE layer's are [L, E, ...], a dense one's [L, "
                           "...])")
        return {**_tensors(head, want, dev, "lm params"),
                "layers": _tensors(layers,
                                   MOE_LAYER_LEAVES if moe else LAYER_LEAVES,
                                   dev, "lm layers")}
    if family == "gnn":
        layers = []
        for i, lp in enumerate(tree["layers"]):
            extra = set(lp) - {"w_self", "b"}
            convs = [c for c, leaves in GNN_LAYER_LEAVES.items()
                     if leaves == extra]
            if not convs:
                raise KeyError(f"gnn layer {i}: leaves {sorted(lp)} match "
                               f"no conv of {sorted(GNN_LAYER_LEAVES)}")
            layers.append(_tensors(lp, extra | {"w_self", "b"}, dev,
                                   f"gnn layer {i}"))
        head = {k: v for k, v in tree.items() if k != "layers"}
        return {"layers": layers,
                **_tensors(head, {"readout", "readout_b"}, dev, "gnn head")}
    raise ValueError(f"no params conversion for family {family!r}")


def state_from_arrays(family: str, state: dict, device="cuda") -> dict:
    """A cell's state ``{"params"[, "opt": {"m", "v", "step"}]}`` of
    numpy arrays as the port's: params and the float32 moments on
    ``device`` (each moment tree with the params' leaves), the step an
    int32 0-d tensor on the host (see ``optim.optimizer``)."""
    extra = set(state) - {"params", "opt"}
    if extra:
        raise KeyError(f"state: unexpected entries {sorted(extra)}")
    out = {"params": params_from_arrays(family, state["params"], device)}
    if "opt" in state:
        opt = state["opt"]
        if set(opt) != {"m", "v", "step"}:
            raise KeyError(f"opt state: entries {sorted(opt)}, expected "
                           f"['m', 'step', 'v']")
        out["opt"] = {"step": torch.tensor(int(np.asarray(opt["step"])),
                                           dtype=torch.int32)}
        for name in ("m", "v"):
            moments = params_from_arrays(family, opt[name], device)
            bad = [t.dtype for t in _leaves(moments)
                   if t.dtype != torch.float32]
            if bad:
                raise TypeError(f"opt state {name}: moments are float32, "
                                f"got {bad[0]}")
            out["opt"][name] = moments
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    if isinstance(tree, list):
        return [leaf for value in tree for leaf in _leaves(value)]
    return [tree]
