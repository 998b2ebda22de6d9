"""Carry a model's parameters across from the reference package.

``params_from_arrays`` takes a params tree as the reference's
``init_params`` builds it, with numpy arrays for leaves (the reference's
arrays through ``np.asarray``), and returns the same tree of tensors on
``device``, checking that every leaf this package's forward reads is
there and no other. The tests use it to run both packages on the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.query_torch import resolve_device
from .transformer import LAYER_LEAVES

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
        return {**_tensors(head, want, dev, "lm params"),
                "layers": _tensors(tree["layers"], LAYER_LEAVES, dev,
                                   "lm layers")}
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
