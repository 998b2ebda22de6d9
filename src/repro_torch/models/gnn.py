"""GNN model zoo: GCN, GraphSAGE, GatedGCN, GIN.

Message passing is edge-gather (``index_select``) → ``ops.segment_mp``
scatter (``index_add``), as the reference's ``jax.ops.segment_*``. Three
input regimes, one weight set:

  * full_graph  — edge lists over the whole graph (Cora / ogbn-products)
  * minibatch   — sampled block-bipartite subgraphs (GraphSAGE regime);
                  layer l aggregates hop-(l+1) nodes into hop-l nodes
  * dense_batch — [B, N, N] adjacency for molecule batches; the gin, gcn
                  and sage aggregation is the ``batched_mp`` contract,
                  ``(adj @ x) @ w`` (kernel 9 on a card, forward and
                  backward); gatedgcn's per-edge gates are plain einsums,
                  as in the reference.

``cfg.remat`` checkpoints each layer of ``forward_full``
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps each
layer in ``jax.checkpoint``.

On a mesh (the reference's full-graph sharding: nodes and edges over
('pod', 'data')), ``forward_full`` takes a ``GraphPart``: the rank holds
a block of the node rows and of the edges. Each layer gathers the whole
node states that its edges read (``parallel.gather_from_group``, whose
backward sums over the group and cuts), scatters its edge block's
messages into a whole [n, d] partial, reduces the partials over the
group (``sharded_segment_reduce``, the reference's
``_sharded_segment_reduce``: a local segment sum or max, then an
all-reduce) and keeps its rows; the dense-batch regime runs on a data
rank's graphs as it is.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..configs.base import GNNConfig
from ..kernels import ops
from ..parallel.collectives import all_reduce_, gather_from_group
from .common import normal_init


@dataclass(frozen=True)
class GraphPart:
    """A rank's part of a graph on a mesh: node rows ``rows`` (r0, r1),
    split over ``group`` (its global ranks in block order ``ranks``, this
    rank at ``index``); ``edges_split``: src and dst are this rank's
    block of the edges, split over the same group, else every edge (the
    reference's fallback where the data ranks do not divide them)."""
    group: object
    ranks: tuple
    index: int
    rows: tuple
    edges_split: bool


class _ShardedSegmentReduce(torch.autograd.Function):
    """Forward: the local segment sum or max of this rank's edge block
    into a whole [n, ...] partial, reduced over ``group`` (SUM or MAX),
    then rows r0 .. r1 − 1. Backward: the cotangents of the rows, each
    rank's share, summed over the group into the whole cotangent; a sum
    passes it to each edge's segment, a max to the edges equal to their
    segment's max, split evenly over every such edge of the group (as
    ``jax.grad`` of ``segment_max`` splits a tie on one device)."""

    @staticmethod
    def forward(ctx, x, seg, n: int, group, rows, reduce: str):
        part = ops.segment_mp(x, seg, n, reduce)
        all_reduce_(part, group, "segment_" + reduce,
                    op=dist.ReduceOp.SUM if reduce == "sum"
                    else dist.ReduceOp.MAX)
        ctx.n, ctx.group, ctx.rows, ctx.reduce = n, group, rows, reduce
        ctx.save_for_backward(x, seg, part if reduce == "max" else None)
        return part[rows[0]:rows[1]]

    @staticmethod
    def backward(ctx, g):
        x, seg, whole = ctx.saved_tensors
        r0, r1 = ctx.rows
        full = g.new_zeros((ctx.n, *g.shape[1:]))
        full[r0:r1] = g
        all_reduce_(full, ctx.group, "segment_grad")
        idx = seg.long()
        if ctx.reduce == "sum":
            return full[idx], None, None, None, None, None
        hit = (x == whole[idx]).to(g.dtype)
        count = all_reduce_(ops.segment_mp(hit, seg, ctx.n), ctx.group,
                            "segment_grad")
        return full[idx] * hit / count[idx], None, None, None, None, None


def sharded_segment_reduce(x, seg, n: int, group, rows,
                           reduce: str = "sum"):
    """Rows ``rows`` (r0, r1) of the segment ``reduce`` ("sum" or "max")
    of the messages ``x [m, ...]`` into ``n`` segments by ``seg``, where
    each rank of ``group`` holds a block of the messages (group None: a
    rank holds every message). Each rank's cotangent of its rows is its
    share of the loss's (``_ShardedSegmentReduce``)."""
    return _ShardedSegmentReduce.apply(x, seg, n, group, tuple(rows),
                                       reduce)


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


def param_shapes(cfg: GNNConfig, d_feat: int, n_classes: int) -> dict:
    """The shape of every leaf of ``init_params``' tree (no allocation);
    the reference replicates them all (``param_logical_axes_tree``)."""
    L, Hd = cfg.n_layers, cfg.d_hidden
    dims = [d_feat] + [Hd] * L
    extra = {"gcn": {}, "sage": {"w_neigh": "io"},
             "gin": {"w2": "oo", "b2": "o", "eps": ""},
             "gatedgcn": {"wA": "io", "wB": "io", "wV": "io"}}[cfg.conv]
    layers = []
    for i in range(L):
        size = {"i": dims[i], "o": dims[i + 1]}
        lp = {"w_self": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
        lp.update({k: tuple(size[c] for c in code)
                   for k, code in extra.items()})
        layers.append(lp)
    return {"layers": layers, "readout": (Hd, n_classes),
            "readout_b": (n_classes,)}


def _act(h, last: bool):
    return h if last else torch.relu(h)


# ------------------------------------------------------------ one conv ----

def _conv_sparse(cfg: GNNConfig, lp, x_src, x_dst, src, dst, n_dst,
                 deg_dst=None, deg_src=None, part: GraphPart | None = None):
    """One conv layer on an edge list. x_src: features of the source side
    (hop l+1); x_dst: features of the destination side (hop l, the ones
    being updated). src / dst index rows of x_src / x_dst. Under
    ``part`` (a full graph on a mesh) x_src is every node's features,
    x_dst this rank's rows of them, dst indexes the whole, deg_dst is
    whole, and the result is this rank's rows."""
    msgs = torch.index_select(x_src, 0, src)
    at_dst, deg_self = x_dst, deg_dst
    if part is None:
        def ssum(v):
            return ops.segment_mp(v, dst, n_dst, "sum")
    else:
        at_dst, deg_self = x_src, deg_dst[part.rows[0]:part.rows[1]]
        group = part.group if part.edges_split else None

        def ssum(v):
            return sharded_segment_reduce(v, dst, n_dst, group, part.rows)

    if cfg.conv == "gcn":
        # symmetric normalization 1/sqrt(d_i d_j)
        norm = torch.rsqrt(torch.clamp(
            torch.index_select(deg_src, 0, src)
            * torch.index_select(deg_dst, 0, dst), min=1.0))
        agg = ssum(msgs * norm[:, None])
        agg = agg + x_dst * torch.rsqrt(
            torch.clamp(deg_self * deg_self, min=1.0))[:, None]
        return agg @ lp["w_self"] + lp["b"]
    if cfg.conv == "sage":
        cnt = ssum(msgs.new_ones((msgs.shape[0], 1)))
        agg = ssum(msgs) / torch.clamp(cnt, min=1.0)
        return x_dst @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"]
    if cfg.conv == "gin":
        agg = ssum(msgs)
        h = (1.0 + lp["eps"]) * x_dst + agg
        h = torch.relu(h @ lp["w_self"] + lp["b"])
        return h @ lp["w2"] + lp["b2"]
    if cfg.conv == "gatedgcn":
        gate = torch.sigmoid(
            torch.index_select(x_src, 0, src) @ lp["wA"]
            + torch.index_select(at_dst, 0, dst) @ lp["wB"])
        vals = (msgs @ lp["wV"]) * gate
        agg = ssum(vals) / (ssum(gate) + 1e-6)
        return x_dst @ lp["w_self"] + agg + lp["b"]
    raise ValueError(cfg.conv)


def _ones(n: int, device):
    return torch.ones(n, dtype=torch.float32, device=device)


# ------------------------------------------------------------- full graph --

def forward_full(cfg: GNNConfig, params, feats, src, dst, n_nodes: int,
                 part: GraphPart | None = None):
    """Full-graph node classification logits [n, n_classes]; src, dst [m]
    int edge endpoints in [0, n_nodes). Under ``part``: feats are this
    rank's node rows and src, dst its edges (or every edge), and the
    logits are its rows."""
    deg_in = ops.segment_mp(_ones(dst.shape[0], dst.device), dst, n_nodes)
    deg_out = ops.segment_mp(_ones(src.shape[0], src.device), src, n_nodes)
    if part is not None and part.edges_split:      # the whole degrees
        all_reduce_(deg_in, part.group, "degree")
        all_reduce_(deg_out, part.group, "degree")
    x = feats
    L = cfg.n_layers

    def one_layer(lp, x, last):
        if part is None:
            x = _conv_sparse(cfg, lp, x, x, src, dst, n_nodes,
                             deg_dst=deg_in, deg_src=deg_out)
        else:
            whole = gather_from_group(x, part.group, 0, part.ranks,
                                      part.index)
            x = _conv_sparse(cfg, lp, whole, x, src, dst, n_nodes,
                             deg_dst=deg_in, deg_src=deg_out, part=part)
        return _act(x, last)

    for i, lp in enumerate(params["layers"]):
        if cfg.remat:
            x = checkpoint(one_layer, lp, x, i == L - 1, use_reentrant=False)
        else:
            x = one_layer(lp, x, i == L - 1)
    return x @ params["readout"] + params["readout_b"]


# -------------------------------------------------------------- minibatch --

def forward_minibatch(cfg: GNNConfig, params, hop_feats, hop_edges):
    """Sampled-subgraph forward (GraphSAGE regime).

    hop_feats: list of [n_hop_l, d] feature tensors, hop 0 = the targets.
    hop_edges: list of (src_idx, dst_idx) for each layer l, indexing into
    hop l+1 (src) and hop l (dst).
    """
    L = cfg.n_layers
    xs = list(hop_feats)
    for l in range(L):  # layer l consumes hop l+1 into hop l, iteratively
        new_xs = []
        lp = params["layers"][l]
        for h in range(L - l):
            src, dst = hop_edges[h]
            n_dst = xs[h].shape[0]
            deg = ops.segment_mp(_ones(dst.shape[0], dst.device), dst, n_dst)
            out = _conv_sparse(cfg, lp, xs[h + 1], xs[h], src, dst, n_dst,
                               deg_dst=deg + 1.0,
                               deg_src=_ones(xs[h + 1].shape[0],
                                             xs[h + 1].device))
            new_xs.append(_act(out, l == L - 1))
        xs = new_xs
    return xs[0] @ params["readout"] + params["readout_b"]


# ------------------------------------------------------------ dense batch --


def forward_dense(cfg: GNNConfig, params, adj, feats):
    """Molecule batches: adj [B, N, N], feats [B, N, d]. Graph-level logits
    [B, n_classes] via mean readout. Aggregation = batched dense matmul
    (kernel 9 on a card, and kernel 9 again in the backward: the
    reference's train step runs its plain einsums instead)."""
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
