"""Uniform step contract for the (architecture × shape) cells the port
serves and trains.

``build_cell(cfg, shape_name, device)`` returns a CellSpec with

    step(state, batch) -> (state, out)

over tensors on the cell's device, plus the batch's shapes and dtypes.
Kinds: train (the dense LMs, the GNNs' full_graph / minibatch /
dense_batch, MIND's sampled softmax), serve and retrieval (recsys),
prefill and decode (every LM), classify (ferrari-web, the paper's
own system: phase-1 verdicts over the fused index layout, kernel 1 on a
card). The MoE LMs and the int8 KV cache run the prefill and decode
cells (a decode cell's state holds ``init_cache``'s int8 cache) and the
train cell. A train step takes the gradient, then one AdamW step in
place; the LM step accumulates float32 gradients over
``cfg.microbatches`` microbatches first. The GNN minibatch kind runs
``forward_full`` over the merged sampled subgraph, as the reference's
step does; the dense-batch kind runs ``forward_dense``, whose aggregation
is kernel 9 forward and backward on a card (the reference's step passes
``use_pallas=False``).
Every cell also takes a mesh (``launch.mesh.Mesh``, of which
``core.distributed.ServingMesh`` is the (data, model) case; one process
a rank), as the reference's ``build_cell(cfg, shape, mesh)`` places and
steps every cell on one. Each rank holds the reference's block of every
leaf: ``parallel.sharding.logical_to_spec`` of its logical axes
(``CellSpec.state_shardings()``, m and v further split over ('pod',
'data') by ZeRO-1; ``batch_shardings()`` for the batch), with the
reference's rule overrides (MoE decode's experts' mlp dim over 'data',
the sharded ferrari cell's rows over 'model'). ``materialize_state``
draws the whole state from the seed on every rank and keeps the rank's
blocks; ``shard_state`` cuts a whole state. A step takes the whole batch
on every rank and cuts the rank's block under the batch's placements;
its answers (logits, interests, scores) come back whole on every rank,
its state as the rank's blocks. The collectives XLA's partitioner
places for the reference are written out:

  * LM train (dense and MoE): each data rank a block of every
    microbatch, the layer tensor-parallel over 'model'
    (``transformer.TensorParallel``: column/row pairs, the reference's
    padded and expanded heads, vocab-parallel embedding and loss), the
    MoE FFN expert-parallel (``transformer.ExpertMesh``, its router and
    stacks the state's blocks); the gradients averaged over the data
    ranks, ZeRO-1 updates all-gathered, the clipping norm counting each
    split leaf once (``_mesh_update``, shared by every family).
  * LM prefill: the rank's rows of the batch through the same layer
    (kernel 6 on the rank's heads), the last-token logits gathered over
    'model' and the data ranks, the cache the rank's block
    (``transformer.cache_shard``).
  * LM decode: the cache's sequence over ('data', 'model') at a batch of
    one, or the batch over the data ranks and the sequence over 'model'
    (or its kv heads, where 'model' does not divide the sequence);
    flash-decoding's partial softmaxes combined over the sequence's ranks
    (``models.attention.decode_attention``).
  * GNN full_graph and minibatch: nodes and edges over ('pod', 'data')
    (``gnn.GraphPart``, ``gnn.sharded_segment_reduce``), each rank's loss
    its share of the masked mean, the gradients summed; dense_batch: a
    data rank's graphs (kernel 9 forward and backward on them), the
    gradients averaged.
  * MIND: the table's rows over 'model' (``recsys.TableShard``, masked
    lookups summed over the model group); train and serve over the data
    ranks' users, retrieval over their candidates (kernel 10 on them).
  * ferrari: the sharded placement's ``classify_sharded`` on the rank's
    rows (compute-at-owner, kernel 1's owned-rows entry on a card), every
    rank the whole batch, where the reference's cell shards over 'model'
    on a mesh with that axis; replicated otherwise.

At world 1 every cell steps as the cell without a mesh, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import (FerrariServeConfig, GNNConfig, LMConfig,
                            RecsysConfig, shapes_for_family)
from ..core.query_torch import resolve_device
from ..optim.optimizer import (OptConfig, _leaves, _map, adamw_init,
                               adamw_update)
from ..parallel import sharding as shd
from ..parallel.collectives import all_gather_, all_reduce_
from . import gnn as gnn_mod
from . import recsys as rec_mod
from . import transformer as tf_mod
from .common import cross_entropy

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
    state_shapes: Optional[Dict[str, Tuple[Tuple[int, ...],
                                           torch.dtype]]] = None
    model_flops_fn: Optional[Callable] = None
    # on a mesh: the MoE FFN's expert parallelism, the layer's tensor
    # parallelism and the decode cache's block (the LM cells)
    expert_mesh: Optional[tf_mod.ExpertMesh] = None
    tp: Optional[tf_mod.TensorParallel] = None
    cache_shard: Optional[tf_mod.CacheShard] = None
    # the mesh, the leaves' logical axes and whole shapes, the reference's
    # rule overrides (MoE decode, the sharded ferrari cell)
    mesh: Any = None
    state_logical: Any = None
    state_whole: Any = None
    batch_logical: Optional[Dict[str, Any]] = None
    rules: Optional[dict] = None

    def state_shardings(self, zero1: bool = True):
        """The state's placements (a tree of ``sharding.Placement``), m
        and v under ZeRO-1 with ``zero1``; None off a mesh."""
        if self.mesh is None or self.state_logical is None:
            return None
        return _placements(self.mesh, self.state_logical, self.state_whole,
                           zero1, self.rules)

    def batch_shardings(self):
        """The batch's placements; None off a mesh."""
        if self.mesh is None or self.batch_logical is None:
            return None
        return {k: shd.named_sharding(self.batch_logical[k], shape,
                                      self.mesh, self.rules)
                for k, (shape, _) in self.batch_shapes.items()}


def _placements(mesh, logical, whole, zero1: bool = True, rules=None):
    """The placements of a state of ``logical`` axes and ``whole`` shapes
    on ``mesh`` under the reference's rules and ``rules``; with ``zero1``
    m and v under ``zero1_spec``."""
    out = shd.tree_shardings(logical, whole, mesh, rules)
    if zero1 and "opt" in out:
        for mv in ("m", "v"):
            out["opt"][mv] = _map2(
                lambda p, shape: shd.Placement(
                    mesh, shd.zero1_spec(p.spec, shape, mesh)),
                out["opt"][mv], whole["opt"][mv])
    return out


def _map2(fn, tree, other):
    """``fn`` over the leaves of ``tree`` and the matching entries of
    ``other`` (dicts by key, lists by position)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def value_and_grad(loss_fn, params):
    """(detached loss, grads in ``params``' tree) of ``loss_fn(params)``.
    The grads are taken on views of the params (``detach``, no copy), so
    the AdamW step after it may update the params in place."""
    live = _map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(live)
    flat = _leaves(live)
    grads = iter(torch.autograd.grad(loss, flat, materialize_grads=True))
    return loss.detach(), _map(lambda _: next(grads), live)


def _train_step(opt_cfg: OptConfig, loss_fn):
    """step(state, batch) of one gradient and one AdamW step in place."""
    def step(state, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch),
                                      state["params"])
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                            state["opt"])
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics
    return step


# ------------------------------------------------------------ on a mesh ----

def _opt_tree(p):
    return {"m": p, "v": p, "step": ()}


def _state_logical(cfg, shape):
    """(logical axes, whole shapes) of the cell's state, the reference's:
    the params (+ AdamW's m, v and step for train, + the decode cache)."""
    if cfg.family == "lm":
        p_log, p_shape = tf_mod.param_logical_axes(cfg), tf_mod.param_shapes(
            cfg)
    elif cfg.family == "gnn":
        p_shape = gnn_mod.param_shapes(cfg, shape.d_feat, shape.n_classes)
        p_log = _map(lambda s_: (None,) * len(s_), p_shape)
    elif cfg.family == "recsys":
        p_log, p_shape = (rec_mod.param_logical_axes(cfg),
                          rec_mod.param_shapes(cfg))
    else:                                           # ferrari
        ixl = ("index_nodes", None)
        n, K = cfg.n_nodes, cfg.k_max
        return ({"slab": ixl, "meta": ixl},
                {"slab": (n, 2 * K), "meta": (n, 4)})
    logical, whole = {"params": p_log}, {"params": p_shape}
    if shape.kind in ("train", "full_graph", "minibatch", "dense_batch"):
        logical["opt"], whole["opt"] = _opt_tree(p_log), _opt_tree(p_shape)
    if shape.kind == "decode":
        logical["cache"] = tf_mod.cache_logical_axes(cfg)
        whole["cache"] = tf_mod.cache_shapes(cfg, shape.batch,
                                             shape.seq_len)
    return logical, whole


_BATCH_LOGICAL = {
    ("lm", "train"): {"tokens": ("batch", None), "labels": ("batch", None)},
    ("lm", "prefill"): {"tokens": ("batch", None)},
    ("lm", "decode"): {"token": ("batch", None), "pos": ()},
    ("gnn", "full_graph"): {"feats": ("nodes", None), "src": ("edges",),
                            "dst": ("edges",), "labels": ("nodes",)},
    ("gnn", "minibatch"): {"feats": ("nodes", None), "src": ("edges",),
                           "dst": ("edges",), "labels": ("nodes",)},
    ("gnn", "dense_batch"): {"adj": ("batch", None, None),
                             "feats": ("batch", None, None),
                             "labels": ("batch",)},
    ("recsys", "train"): {"hist_ids": ("batch", None),
                          "hist_mask": ("batch", None),
                          "target": ("batch",),
                          "negatives": ("batch", None)},
    ("recsys", "serve"): {"hist_ids": ("batch", None),
                          "hist_mask": ("batch", None)},
    ("recsys", "retrieval"): {"hist_ids": (None, None),
                              "hist_mask": (None, None),
                              "cand_ids": ("query",)},
    ("ferrari", "classify"): {"cs": ("query",), "ct": ("query",)},
}


def _rules(cfg, shape, mesh):
    """The reference's rule overrides of a cell: the MoE decode cells'
    experts' mlp dim over 'data', and the sharded ferrari cell's rows
    over 'model'."""
    if cfg.family == "lm" and cfg.moe is not None and shape.kind == "decode":
        return {"mlp": "data"}
    if cfg.family == "ferrari" and _ferrari_sharded(cfg, mesh):
        return {"index_nodes": "model"}
    return None


@dataclass
class _OnMesh:
    """What a cell's step needs on a mesh: the mesh, the rule overrides,
    the state's placements and the batch's."""
    mesh: Any
    rules: Optional[dict]
    state: Any
    batch: Dict[str, shd.Placement]

    def split(self, name: str):
        """The mesh axes that dim 0 of batch leaf ``name`` is split over,
        or None where it is whole on every rank."""
        spec = self.batch[name].spec
        entry = spec[0] if spec else None
        return entry if entry is not None and self.mesh.size(entry) > 1 \
            else None

    def local(self, batch: dict) -> dict:
        """This rank's blocks of a whole batch."""
        return {k: shd.local_slice(v, self.batch[k].spec, self.mesh)
                for k, v in batch.items()}

    def gather(self, t, name: str):
        """``t``, this rank's rows of an answer to batch leaf ``name``'s
        rows, gathered whole over their ranks."""
        entry = self.split(name)
        if entry is None:
            return t
        return all_gather_(t, self.mesh.group(entry), 0,
                           self.mesh.members(entry), "answers")


def _mesh_update(opt_cfg: OptConfig, mesh, placements, whole_params,
                 mean: bool):
    """update(state, loss, grads) -> (state, metrics): the train step on
    a mesh after the gradient, shared by every family. The loss and the
    gradients are summed over the data ranks (and divided by their
    number with ``mean``: each rank's loss is the mean over its equal
    block; else it is its share of the whole loss), the clipping norm
    counts each leaf split over more ranks once (``_sharded_grad_norm``),
    each data rank updates its ZeRO-1 block of every param from its
    blocks of m and v, and the blocks are all-gathered."""
    dp_group, n_dp = mesh.group(mesh.dp_axes), mesh.size(mesh.dp_axes)
    p_specs = [p.spec for p in _leaves(placements["params"])]
    m_specs = [p.spec for p in _leaves(placements["opt"]["m"])]
    # each leaf's group for the clipping norm: the axes it is split over
    norm_groups = [mesh.group(shd.spec_axes(spec)) for spec in p_specs]
    # ZeRO-1: the dim m and v split further over the data axes
    shards, zero_axes = zip(*(
        _zero1_block(shape, ps, ms, mesh) for shape, ps, ms in zip(
            _leaves(whole_params), p_specs, m_specs)))

    def update(state, loss, grads):
        if dp_group is not None:
            for leaf in _leaves(grads):
                all_reduce_(leaf, dp_group, "grad_sum")
                if mean:
                    leaf.div_(n_dp)
            loss = all_reduce_(loss.clone(), dp_group, "loss")
            if mean:
                loss = loss / n_dp
        gnorm = _sharded_grad_norm(grads, norm_groups)
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                            state["opt"], gnorm=gnorm,
                                            shards=shards)
        for p, sh, axes in zip(_leaves(params), shards, zero_axes):
            if sh is not None:            # ZeRO-1: the updated blocks
                p.copy_(all_gather_(p.narrow(*sh), mesh.group(axes),
                                    sh[0], mesh.members(axes),
                                    name="zero1_gather"))
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return update


def _mesh_train_step(opt_cfg: OptConfig, on: _OnMesh, whole_params, loss_fn,
                     mean: bool):
    """step(state, batch) on a mesh: the whole batch in, this rank's
    blocks of it to ``loss_fn(params, local batch)``, then
    ``_mesh_update``."""
    update = _mesh_update(opt_cfg, on.mesh, on.state, whole_params, mean)

    def step(state, batch):
        local = on.local(batch)
        loss, grads = value_and_grad(lambda p: loss_fn(p, local),
                                     state["params"])
        return update(state, loss, grads)
    return step


# ------------------------------------------------------------------ GNN ----

def _gnn_subgraph_sizes(shape):
    """Sampled-subgraph (GraphSAINT-style) sizes from batch_nodes ×
    fanout."""
    hops = [shape.batch_nodes]
    for f in shape.fanout:
        hops.append(hops[-1] * f)
    n_sub = _pad(sum(hops))
    m_sub = _pad(sum(hops[i + 1] for i in range(len(shape.fanout))))
    return n_sub, m_sub


def _masked_ce(logits, labels, count=None):
    """Mean cross-entropy over the nodes whose label is >= 0; ``count``:
    the number of such nodes where ``labels`` are a rank's rows of them
    (each rank's value is then its share of the whole's mean)."""
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, lab[:, None])[:, 0]
    return torch.sum((lse - ll) * mask) / torch.clamp(
        mask.sum() if count is None else count, min=1)


def _graph_part(on: _OnMesh, n: int):
    """This rank's ``gnn.GraphPart`` of a full graph of ``n`` nodes on the
    mesh (its node rows and edges under the batch's placements); None
    where the nodes are whole on every rank."""
    entry, e_entry = on.split("feats"), on.split("src")
    if entry is None:
        if e_entry is not None:
            raise ValueError("the edges split over the data ranks, the "
                             "nodes do not")
        return None
    if e_entry is not None and e_entry != entry:
        raise ValueError(f"nodes over {entry}, edges over {e_entry}")
    mesh = on.mesh
    blk, i = n // mesh.size(entry), mesh.index(entry)
    return gnn_mod.GraphPart(mesh.group(entry), tuple(mesh.members(entry)),
                             i, (i * blk, (i + 1) * blk),
                             e_entry is not None)


def _gnn_cell(cfg: GNNConfig, shape, opt_cfg: OptConfig,
              on: Optional[_OnMesh] = None, info=None):
    i32, f32 = torch.int32, torch.float32
    d = cfg.d_hidden
    whole = gnn_mod.param_shapes(cfg, shape.d_feat, shape.n_classes)
    if shape.kind in ("full_graph", "minibatch"):
        if shape.kind == "full_graph":
            n, m = _pad(shape.n_nodes), _pad(shape.n_edges)
        else:
            n, m = _gnn_subgraph_sizes(shape)
        batch_shapes = {"feats": ((n, shape.d_feat), f32),
                        "src": ((m,), i32), "dst": ((m,), i32),
                        "labels": ((n,), i32)}
        # 3x fwd-cost (fwd+bwd); per layer: edge msgs (m*d) + dense (n*d*d)
        flops_fn = lambda: 3 * cfg.n_layers * (2 * m * d + 2 * n * d * d) \
            + 3 * 2 * n * shape.d_feat * d                       # noqa: E731
        if on is None:
            def loss_fn(p, batch):
                logits = gnn_mod.forward_full(cfg, p, batch["feats"],
                                              batch["src"], batch["dst"], n)
                return _masked_ce(logits, batch["labels"])
            return _train_step(opt_cfg, loss_fn), batch_shapes, None, \
                flops_fn
        on.batch = _batch_pl(on, cfg, shape, batch_shapes)
        part = _graph_part(on, n)

        def loss_fn(p, b):
            logits = gnn_mod.forward_full(cfg, p, b["feats"], b["src"],
                                          b["dst"], n, part)
            count = None
            if part is not None:             # the whole's labelled nodes
                count = all_reduce_((b["labels"] >= 0).float().sum(),
                                    part.group, "label_count")
            return _masked_ce(logits, b["labels"], count)
        return _mesh_train_step(opt_cfg, on, whole, loss_fn, mean=False), \
            batch_shapes, None, flops_fn

    if shape.kind == "dense_batch":
        B, N = shape.batch_graphs, shape.nodes_per_graph
        batch_shapes = {"adj": ((B, N, N), f32),
                        "feats": ((B, N, shape.d_feat), f32),
                        "labels": ((B,), i32)}

        def loss_fn(p, batch):
            logits = gnn_mod.forward_dense(cfg, p, batch["adj"],
                                           batch["feats"])
            return cross_entropy(logits, batch["labels"])

        flops_fn = lambda: 3 * cfg.n_layers * B * (                # noqa: E731
            2 * N * N * d + 2 * N * d * d)
        if on is None:
            return _train_step(opt_cfg, loss_fn), batch_shapes, None, \
                flops_fn
        on.batch = _batch_pl(on, cfg, shape, batch_shapes)
        # a data rank's graphs (kernel 9 forward and backward on them)
        return _mesh_train_step(opt_cfg, on, whole, loss_fn, mean=True), \
            batch_shapes, None, flops_fn
    raise ValueError(shape.kind)


# --------------------------------------------------------------- recsys ----

def _recsys_cell(cfg: RecsysConfig, shape, opt_cfg: OptConfig,
                 on: Optional[_OnMesh] = None, info=None):
    Lh = cfg.hist_len
    D, K = cfg.embed_dim, cfg.n_interests
    i32, f32 = torch.int32, torch.float32
    shard = None
    if on is not None:
        entry = on.state["params"]["table"].spec[0]
        if entry is not None and on.mesh.size(entry) > 1:
            blk = cfg.n_items // on.mesh.size(entry)
            lo = on.mesh.index(entry) * blk
            shard = rec_mod.TableShard(on.mesh.group(entry), lo, lo + blk)

    if shape.kind == "train":
        B = shape.batch
        batch_shapes = {"hist_ids": ((B, Lh), i32),
                        "hist_mask": ((B, Lh), f32),
                        "target": ((B,), i32),
                        "negatives": ((B, cfg.n_negatives), i32)}
        flops_fn = lambda: 3 * B * (                               # noqa: E731
            2 * Lh * D * D + cfg.capsule_iters * 4 * K * Lh * D
            + 2 * (1 + cfg.n_negatives) * D)
        if on is None:
            step = _train_step(
                opt_cfg, lambda p, batch: rec_mod.train_loss(cfg, p, batch))
            return step, batch_shapes, None, flops_fn
        on.batch = _batch_pl(on, cfg, shape, batch_shapes)
        step = _mesh_train_step(
            opt_cfg, on, rec_mod.param_shapes(cfg),
            lambda p, b: rec_mod.train_loss(cfg, p, b, shard), mean=True)
        return step, batch_shapes, None, flops_fn

    if shape.kind == "serve":
        B = shape.batch
        batch_shapes = {"hist_ids": ((B, Lh), i32),
                        "hist_mask": ((B, Lh), f32)}
        if on is not None:
            on.batch = _batch_pl(on, cfg, shape, batch_shapes)

        def step(state, batch):
            if on is not None:
                batch = on.local(batch)
            caps = rec_mod.serve_interests(cfg, state["params"],
                                           batch["hist_ids"],
                                           batch["hist_mask"], shard)
            if on is not None:
                caps = on.gather(caps, "hist_ids")
            return state, caps

        return step, batch_shapes, None, lambda: B * (
            2 * Lh * D * D + cfg.capsule_iters * 4 * K * Lh * D)

    if shape.kind == "retrieval":
        C = _pad(shape.n_candidates)
        batch_shapes = {"hist_ids": ((1, Lh), i32),
                        "hist_mask": ((1, Lh), f32),
                        "cand_ids": ((C,), i32)}
        if on is not None:
            on.batch = _batch_pl(on, cfg, shape, batch_shapes)

        def step(state, batch):
            if on is not None:
                batch = on.local(batch)
            caps = rec_mod.serve_interests(cfg, state["params"],
                                           batch["hist_ids"],
                                           batch["hist_mask"], shard)
            scores = rec_mod.retrieval_scores(cfg, state["params"], caps[0],
                                              batch["cand_ids"], shard)
            if on is not None:              # a data rank's candidates
                scores = on.gather(scores, "cand_ids")
            return state, scores

        return step, batch_shapes, None, lambda: 2 * C * D * K
    raise ValueError(shape.kind)


def _lm_grads(cfg: LMConfig, params, tokens, labels, loss_chunk, ep=None,
              tp=None):
    """(float32 loss, grads) of one batch: the grads in the params'
    dtypes, in ``params``'s tree with each stacked layer leaf replaced by
    the list of its per-layer gradients (``transformer.layer_leaves``);
    the MoE configs' float32 ``router`` among them."""
    leaves = tf_mod.layer_leaves(params)
    loss = tf_mod.logits_and_loss(cfg, leaves, tokens, labels, loss_chunk,
                                  ep, tp)
    top = [name for name in leaves if name != "layers"]
    names = tf_mod.MOE_LAYER_LEAVES if cfg.moe else tf_mod.LAYER_LEAVES
    flat = [leaves[name] for name in top] + [
        lp[name] for lp in leaves["layers"] for name in names]
    g = iter(torch.autograd.grad(loss, flat))
    tree = {name: next(g) for name in top}
    per_layer = [{name: next(g) for name in names} for _ in leaves["layers"]]
    tree["layers"] = {name: [lp[name] for lp in per_layer] for name in names}
    return loss.detach(), tree


def _data_block(t, n: int, i: int, mb: int):
    """Data rank ``i``'s rows (of ``n``) of a batch ``t [B, ...]`` of
    ``mb`` microbatches: the i-th of the n blocks of each microbatch (the
    reference's microbatch sharded over the data axes), in microbatch
    order, so that ``chunk(mb)`` gives the rank's part of each."""
    if n == 1:
        return t
    B, rest = t.shape[0], t.shape[1:]
    return t.reshape(mb, n, B // (mb * n), *rest)[:, i].reshape(
        B // n, *rest)


def _accumulate(cfg: LMConfig, params, tokens, labels, mb: int,
                loss_chunk, ep=None, tp=None):
    """(loss, grads) of one batch in ``mb`` microbatches: the grads
    accumulated in float32 microbatch by microbatch (the params' dtypes
    at ``mb`` 1) and averaged, the loss the mean of the microbatches'."""
    if mb == 1:
        loss, g = _lm_grads(cfg, params, tokens, labels, loss_chunk, ep, tp)
        grads = {k: v for k, v in g.items() if k != "layers"}
        grads["layers"] = {k: torch.stack(v) for k, v in g["layers"].items()}
        return loss, grads
    grads = {k: torch.zeros_like(v, dtype=torch.float32)
             for k, v in params.items() if k != "layers"}
    grads["layers"] = {k: torch.zeros_like(v, dtype=torch.float32)
                       for k, v in params["layers"].items()}
    losses = []
    for toks, labs in zip(tokens.chunk(mb), labels.chunk(mb)):
        loss, g = _lm_grads(cfg, params, toks, labs, loss_chunk, ep, tp)
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
    return torch.stack(losses).mean(), grads


def _lm_train_step(cfg: LMConfig, opt_cfg: OptConfig, B: int,
                   loss_chunk: int = 16384):
    mb = max(1, cfg.microbatches)
    if B % mb:
        raise ValueError(f"batch {B} does not split into {mb} microbatches")

    def step(state, batch):
        params = state["params"]
        loss, grads = _accumulate(cfg, params, batch["tokens"],
                                  batch["labels"], mb, loss_chunk)
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"])
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return step


def _zero1_block(shape, p_spec, m_spec, mesh):
    """(dim, start, length) of this rank's ZeRO-1 block of a param of whole
    ``shape`` (its m and v under ``m_spec``) within its block under
    ``p_spec``, and the data axes it is split over; (None, None) where m
    and v are the param's whole block."""
    p_spec = tuple(p_spec) + (None,) * (len(m_spec) - len(p_spec))
    for d, (e, f) in enumerate(zip(m_spec, p_spec)):
        if e != f and mesh.size(e) > 1:
            b = shd.local_shape(shape, p_spec, mesh)[d] // mesh.size(e)
            return (d, mesh.index(e) * b, b), e
    return None, None


def _sharded_grad_norm(grads, groups):
    """The float32 L2 norm of the whole model's gradient from this rank's
    blocks: the leaves whose group is None (whole, or split over one
    rank) summed first, in the leaves' order as ``clip_by_global_norm``
    sums them, then each split leaf's squares summed over its group.
    None where no leaf is split (``clip_by_global_norm`` sums them the
    same way then)."""
    flat = _leaves(grads)
    if all(g is None for g in groups):
        return None

    def sq(ts):
        return sum(torch.sum(torch.square(t.float())) for t in ts)
    total = sq([t for t, g in zip(flat, groups) if g is None])
    split = {}
    for t, g in zip(flat, groups):
        if g is not None:
            split.setdefault(id(g), (g, []))[1].append(t)
    for g, ts in split.values():
        total = total + all_reduce_(sq(ts), g, "grad_norm")
    return torch.sqrt(total)


def _lm_mesh_train_step(cfg: LMConfig, opt_cfg: OptConfig, B: int,
                        on: _OnMesh, tp, ep=None, loss_chunk: int = 16384):
    """The LM train step on a mesh (the module docstring), over states
    placed by ``on.state`` (``CellSpec.state_shardings()``)."""
    mb = max(1, cfg.microbatches)
    mesh = on.mesh
    n_dp, i_dp = mesh.size(mesh.dp_axes), mesh.index(mesh.dp_axes)
    if B % (mb * n_dp):
        raise ValueError(f"batch {B} does not split into {mb} microbatches"
                         f" over {n_dp} data ranks")
    update = _mesh_update(opt_cfg, mesh, on.state, tf_mod.param_shapes(cfg),
                          mean=True)

    def step(state, batch):
        tokens = _data_block(batch["tokens"], n_dp, i_dp, mb)
        labels = _data_block(batch["labels"], n_dp, i_dp, mb)
        loss, grads = _accumulate(cfg, state["params"], tokens, labels, mb,
                                  loss_chunk, ep, tp)
        return update(state, loss, grads)

    return step


def _expert_mesh(shape, mesh, specs, tokens_sharded: bool
                 ) -> tf_mod.ExpertMesh:
    """An MoE LM cell's ``ExpertMesh`` on ``mesh`` over its params'
    ``specs``: decode keeps the whole batch on every rank and splits the
    experts' mlp dim over the data ranks (the reference's ``{"mlp":
    "data"}`` for MoE decode); train and prefill take the data rank's
    block of the batch where the batch's placement splits it (the
    reference's ``tokens_sharded`` rule). The router and the stacks are
    the state's blocks (``stored``)."""
    stored = {name: tuple(specs["layers"][name][1:])
              for name in ("router",) + tf_mod.EXPERT_LEAVES}
    if shape.kind == "decode":
        return tf_mod.ExpertMesh(mesh, tokens_sharded=False,
                                 mlp_over_data=True, stored=stored)
    return tf_mod.ExpertMesh(mesh, tokens_sharded=tokens_sharded,
                             stored=stored)


def _lm_cell(cfg: LMConfig, shape, opt_cfg: OptConfig,
             on: Optional[_OnMesh] = None, info=None):
    B, S = shape.batch, shape.seq_len
    i32 = torch.int32
    shapes = {"train": {"tokens": ((B, S), i32), "labels": ((B, S), i32)},
              "prefill": {"tokens": ((B, S), i32)},
              "decode": {"token": ((B, 1), i32), "pos": ((), i32)}}
    if shape.kind not in shapes:
        raise ValueError(shape.kind)
    batch_shapes = shapes[shape.kind]
    tp = ep = cache = None
    split = None
    if on is not None:
        mesh = on.mesh
        on.batch = _batch_pl(on, cfg, shape, batch_shapes)
        specs = _map(lambda p: p.spec, on.state["params"])
        tp = tf_mod.tensor_parallel(cfg, mesh, specs)
        split = on.split("tokens") if shape.kind != "decode" else None
        if cfg.moe is not None:
            ep = _expert_mesh(shape, mesh, specs, split is not None
                              or mesh.size(mesh.dp_axes) == 1)
        if shape.kind != "train":
            cache = tf_mod.cache_shard(cfg, B, S, mesh, on.rules)
        info.update(tp=tp, expert_mesh=ep, cache_shard=cache)

    # the reference's model FLOPs: 6·N_active·tokens to train, 2·N_active
    # a token forward, and decode's attention over the cache
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        flops_fn = lambda: 6 * n_act * B * S                 # noqa: E731
        if on is not None:
            return _lm_mesh_train_step(cfg, opt_cfg, B, on, tp,
                                       ep), batch_shapes, None, flops_fn
        return _lm_train_step(cfg, opt_cfg, B), batch_shapes, None, \
            flops_fn

    if shape.kind == "prefill":
        def step(state, batch):
            tokens = batch["tokens"]
            if split is not None:        # this data rank's prompts
                tokens = on.local(batch)["tokens"]
            logits, cache_ = tf_mod.prefill(cfg, state["params"], tokens, S,
                                            ep, tp, cache)
            if split is not None:
                logits = on.gather(logits, "tokens")
            return state, {"logits": logits, "cache": cache_}

        return step, batch_shapes, None, lambda: 2 * n_act * B * S

    def step(state, batch):
        # the cache is updated in place (transformer.decode_step)
        logits, cache_ = tf_mod.decode_step(
            cfg, state["params"], state["cache"], batch["token"],
            batch["pos"], ep, tp, cache)
        return {"params": state["params"], "cache": cache_}, logits

    att = (4 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * S * B
           * (cfg.n_heads // cfg.n_kv_heads))
    return step, batch_shapes, None, lambda: 2 * n_act * B + att


def _ferrari_sharded(cfg, mesh) -> bool:
    return (getattr(cfg, "index_placement", "replicated") == "sharded"
            and mesh is not None and "model" in mesh.sizes
            and cfg.n_nodes % mesh.n_model == 0)


def _ferrari_cell(cfg: FerrariServeConfig, shape, opt_cfg: OptConfig,
                  on: Optional[_OnMesh] = None, info=None):
    """Phase-1 classification over the gather-fused layout: state ``slab``
    [n, 2K] (begins with exact flags in the sign bits, then ends) and
    ``meta`` [n, 4] (π | blevel << 24, τ, s⁺, s⁻) int32, from
    ``PackedIndex.to_torch(device, fused=True)``; batch ``cs``, ``ct`` [Q]
    int32 condensed ids. Kernel 1 on a card, its plain version on the
    CPU (the reference's cell runs its plain rules, ``use_pallas=False``).

    Sharded (``index_placement="sharded"`` and a mesh whose model axis M
    divides n): the state is the rank's n / M rows
    (``core.distributed.shard_tables``; the reference's rows over 'model',
    ``state_shardings()``), every rank takes the whole batch and the step
    is ``classify_sharded``, which returns the whole verdict on every
    rank."""
    from ..kernels import ops
    n, K = cfg.n_nodes, cfg.k_max
    i32 = torch.int32
    Q = _pad(shape.n_queries)
    mesh = on.mesh if on is not None else None
    sharded = _ferrari_sharded(cfg, mesh)
    rows = n // mesh.n_model if sharded else n
    state_shapes = {"slab": ((rows, 2 * K), i32), "meta": ((rows, 4), i32)}
    batch_shapes = {"cs": ((Q,), i32), "ct": ((Q,), i32)}
    if on is not None:
        on.batch = _batch_pl(on, cfg, shape, batch_shapes)

    def step(state, batch):
        if sharded:
            from ..core.distributed import classify_sharded
            return state, classify_sharded(mesh, state, batch["cs"],
                                           batch["ct"])
        return state, ops.classify_queries(state, batch["cs"], batch["ct"])

    # ~54 int/cmp ops per query lane over the K-slab + filters
    flops_fn = lambda: Q * (6 * cfg.k_max + 16)   # noqa: E731
    return step, batch_shapes, state_shapes, flops_fn


_CELLS = {"recsys": _recsys_cell, "lm": _lm_cell, "gnn": _gnn_cell,
          "ferrari": _ferrari_cell}


def _batch_pl(on: _OnMesh, cfg, shape, batch_shapes) -> dict:
    logical = _BATCH_LOGICAL[(cfg.family, shape.kind)]
    return {k: shd.named_sharding(logical[k], s, on.mesh, on.rules)
            for k, (s, _) in batch_shapes.items()}


def build_cell(cfg, shape_name: str, device="cuda", shape_override=None,
               opt_cfg: OptConfig | None = None, mesh=None,
               rules: Optional[dict] = None) -> CellSpec:
    """The (arch, shape) cell on ``device``. ``mesh``: a
    ``launch.mesh.Mesh`` (or ``core.distributed.ServingMesh``) to place
    and step the cell on, as the reference's ``build_cell(cfg, shape,
    mesh)`` does (the module docstring); its device is then the cell's.
    This rank must be in the mesh. ``rules``: logical-axis overrides on
    the mesh, as the reference's ``rules=`` (the cell's own overrides,
    MoE decode's and the sharded ferrari cell's, take precedence, as
    there)."""
    shape = shape_override or shapes_for_family(cfg.family)[shape_name]
    opt_cfg = opt_cfg or OptConfig()
    on, info, sharded = None, {}, {}
    if mesh is not None:
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is not in {mesh!r}")
        rules = {**(rules or {}), **(_rules(cfg, shape, mesh) or {})} \
            or None
        logical, whole = _state_logical(cfg, shape)
        on = _OnMesh(mesh, rules, _placements(mesh, logical, whole, True,
                                              rules), {})
        sharded = dict(mesh=mesh, state_logical=logical, state_whole=whole,
                       batch_logical=_BATCH_LOGICAL[(cfg.family,
                                                     shape.kind)],
                       rules=rules)
        device = mesh.device
    dev = resolve_device(device)
    step, batch_shapes, *extra = _CELLS[cfg.family](cfg, shape, opt_cfg,
                                                    on, info)
    state_shapes, flops_fn = extra if extra else (None, None)
    return CellSpec(arch=cfg.arch_id, shape_name=shape_name, kind=shape.kind,
                    step=step, batch_shapes=batch_shapes, device=dev,
                    shape=shape, state_shapes=state_shapes,
                    model_flops_fn=flops_fn, **info, **sharded)


def shard_state(cell: CellSpec, state):
    """This rank's blocks of a whole ``state`` of ``cell`` under
    ``cell.state_shardings()``: copies where a leaf is cut, the state's
    own tensors where it is whole (a train step then updates them in
    place); the state as it is off a mesh."""
    placements = cell.state_shardings()
    if placements is None:
        return state

    def one(p, leaf):
        part = shd.local_slice(leaf, p.spec, p.mesh)
        return part if part.shape == leaf.shape else part.clone()
    return {k: _map2(one, placements[k], v) for k, v in state.items()}


def _draw(cell: CellSpec, cfg, gen: torch.Generator):
    """The cell's whole params (and cache) drawn from ``gen``, as one
    device draws them."""
    if cfg.family == "recsys":
        return {"params": rec_mod.init_params(cfg, gen, cell.device)}
    if cfg.family == "gnn":
        shape = cell.shape
        return {"params": gnn_mod.init_params(cfg, gen, shape.d_feat,
                                              shape.n_classes, cell.device)}
    if cfg.family == "lm":
        state = {"params": tf_mod.init_params(cfg, gen, cell.device)}
        if cell.kind == "decode":
            state["cache"] = tf_mod.init_cache(cfg, cell.shape.batch,
                                               cell.shape.seq_len,
                                               cell.device)
        return state
    if cfg.family == "ferrari":
        raise ValueError("use core.packed.PackedIndex for real ferrari state")
    raise ValueError(cfg.family)


def materialize_state(cell: CellSpec, cfg, shape_name: str,
                      gen: torch.Generator):
    """Real (allocated) state on the cell's device, drawn from ``gen`` (a
    generator on that device); on a mesh, every rank draws the whole
    state from the same seed and keeps its blocks of every leaf
    (``cell.state_shardings``; m and v zeros of their ZeRO-1 blocks'
    shapes, the cache zeros of its block's)."""
    state = _draw(cell, cfg, gen)
    train = cell.kind in ("train", "full_graph", "minibatch", "dense_batch")
    if cell.mesh is None:
        if train:
            state["opt"] = adamw_init(state["params"])
        return state
    pl = cell.state_shardings()
    out = shard_state(cell, {k: v for k, v in state.items()
                             if k != "cache"})
    del state["params"]

    def zeros(p, shape, dtype):
        return torch.zeros(shd.local_shape(shape, p.spec, cell.mesh),
                           dtype=dtype, device=cell.device)
    if "cache" in state:
        out["cache"] = {k: zeros(pl["cache"][k], v.shape, v.dtype)
                        for k, v in state["cache"].items()}
    if train:
        out["opt"] = {mv: _map2(lambda p, shape: zeros(p, shape,
                                                       torch.float32),
                                pl["opt"][mv], cell.state_whole["opt"][mv])
                      for mv in ("m", "v")}
        out["opt"]["step"] = torch.zeros((), dtype=torch.int32)
    return out
