"""GNN model zoo (GCN, GraphSAGE, GatedGCN, GIN): the dense-batch forward.

Molecule batches carry a dense [B, N, N] adjacency; the aggregation of
the gin, gcn and sage convs is the ``batched_mp`` contract (kernel 9 on
a card): ``(adj @ x) @ w``. gatedgcn's per-edge gates are plain einsums,
as in the reference. The full-graph and sampled-minibatch forwards
(segment reductions over edge lists) and training are not ported yet.
"""
from __future__ import annotations

import torch

from ..configs.base import GNNConfig
from ..kernels import ops
from .common import normal_init


def _glorot(gen, shape, dtype, device):
    fan_in, fan_out = shape[-2], shape[-1]
    s = (2.0 / (fan_in + fan_out)) ** 0.5
    return normal_init(gen, shape, s, dtype, device)


def init_params(cfg: GNNConfig, gen: torch.Generator, d_feat: int,
                n_classes: int, device):
    """Per-layer weights and the readout, drawn from ``gen`` (a generator
    on ``device``) layer by layer, then the readout."""
    dt = getattr(torch, cfg.dtype)
    L, Hd = cfg.n_layers, cfg.d_hidden
    dims = [d_feat] + [Hd] * L
    layers = []
    for i in range(L):
        di, do = dims[i], dims[i + 1]
        lp = {"w_self": _glorot(gen, (di, do), dt, device),
              "b": torch.zeros((do,), dtype=dt, device=device)}
        if cfg.conv == "gcn":
            pass  # single weight on aggregated messages: reuse w_self
        elif cfg.conv == "sage":
            lp["w_neigh"] = _glorot(gen, (di, do), dt, device)
        elif cfg.conv == "gin":
            lp["w2"] = _glorot(gen, (do, do), dt, device)
            lp["b2"] = torch.zeros((do,), dtype=dt, device=device)
            lp["eps"] = torch.zeros((), dtype=torch.float32, device=device)
        elif cfg.conv == "gatedgcn":
            lp["wA"] = _glorot(gen, (di, do), dt, device)   # gate: src
            lp["wB"] = _glorot(gen, (di, do), dt, device)   # gate: dst
            lp["wV"] = _glorot(gen, (di, do), dt, device)   # message
        else:
            raise ValueError(cfg.conv)
        layers.append(lp)
    return {"layers": layers,
            "readout": _glorot(gen, (Hd, n_classes), dt, device),
            "readout_b": torch.zeros((n_classes,), dtype=dt, device=device)}


def _act(h, last: bool):
    return h if last else torch.relu(h)


def forward_dense(cfg: GNNConfig, params, adj, feats):
    """Molecule batches: adj [B, N, N], feats [B, N, d]. Graph-level logits
    [B, n_classes] via mean readout. Aggregation = batched dense matmul
    (kernel 9 on a card)."""
    x = feats
    L = cfg.n_layers
    for i, lp in enumerate(params["layers"]):
        last = i == L - 1
        x = x.contiguous()
        if cfg.conv == "gin":
            eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
            agg = ops.batched_mp(adj, x, eye)
            h = (1.0 + lp["eps"]) * x + agg
            h = torch.relu(torch.einsum("bnd,do->bno", h, lp["w_self"])
                           + lp["b"])
            x = _act(torch.einsum("bnd,do->bno", h, lp["w2"]) + lp["b2"],
                     last)
        elif cfg.conv == "gcn":
            deg = torch.clamp(adj.sum(-1, keepdim=True), min=1.0)
            adj_n = adj / torch.sqrt(deg) / torch.sqrt(
                torch.clamp(adj.sum(-2, keepdim=True), min=1.0))
            agg = ops.batched_mp(adj_n, x, lp["w_self"])
            x = _act(agg + lp["b"], last)
        elif cfg.conv == "sage":
            deg = torch.clamp(adj.sum(-1, keepdim=True), min=1.0)
            agg = ops.batched_mp(adj / deg, x, lp["w_neigh"])
            x = _act(torch.einsum("bnd,do->bno", x, lp["w_self"]) + agg
                     + lp["b"], last)
        elif cfg.conv == "gatedgcn":
            a = torch.einsum("bnd,do->bno", x, lp["wA"])
            bb = torch.einsum("bnd,do->bno", x, lp["wB"])
            gate = torch.sigmoid(a[:, :, None, :] + bb[:, None, :, :])
            vals = torch.einsum("bmd,do->bmo", x, lp["wV"])
            num = torch.einsum("bnm,bnmo->bno", adj,
                               gate * vals[:, None, :, :])
            den = torch.einsum("bnm,bnmo->bno", adj, gate) + 1e-6
            x = _act(torch.einsum("bnd,do->bno", x, lp["w_self"])
                     + num / den + lp["b"], last)
        else:
            raise ValueError(cfg.conv)
    pooled = torch.mean(x, dim=1)
    return pooled @ params["readout"] + params["readout_b"]
