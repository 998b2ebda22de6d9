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
A cell runs on one device, with three exceptions that take a mesh
(``launch.mesh.Mesh``, of which ``core.distributed.ServingMesh`` is the
(data, model) case; one process a rank):

  * the dense LM train cell runs sharded, as the reference's cell does on
    a mesh: every leaf placed by ``parallel.sharding.logical_to_spec`` of
    its logical axes (``CellSpec.state_shardings``), the layer
    tensor-parallel over 'model' (``transformer.TensorParallel``), each
    data rank (over ('pod', 'data')) a block of every microbatch, the
    gradients averaged over the data ranks, and ZeRO-1: m and v also
    split over the data ranks (``zero1_spec``), each data rank updating
    its block of the params from its block of m and v and the whole
    gradient, then the blocks all-gathered. The clipping norm counts
    each leaf split over 'model' once (its blocks' squares summed over
    the model group). ``materialize_state`` draws the whole params from
    the seed on every rank and keeps the rank's blocks.
  * the ferrari cell, whose model axis divides n, takes its published
    ``index_placement="sharded"``: its state is the rank's shard of the
    table rows and its step ``classify_sharded`` (compute-at-owner,
    kernel 1's owned-rows entry on a card), as the reference's cell
    shards over 'model' on a mesh with that axis. Without a mesh it runs
    replicated, as the reference's cell does without one.
  * the MoE LM cells run the MoE FFN expert-parallel
    (``transformer.ExpertMesh``): each rank's state holds its model
    rank's E / M experts (``materialize_state``; ``transformer.
    shard_experts``) and every other leaf whole. Train and prefill take
    the data rank's block of the batch (prefill gathers the answers back
    over the data ranks), decode the whole batch with the experts' mlp
    dim also split over the data ranks, as the reference's ``build_cell``
    sets ``{"mlp": "data"}`` for MoE decode. The train step makes the
    reference's implicit gradient sums explicit: the router's and the
    activations' gradients are summed over the model group inside the FFN
    (``parallel.copy_to_group``), every leaf is then averaged over the
    data group, and the clipping norm counts each rank's experts once.
    Their attention stays whole on every rank (a deliberate difference
    from the reference, which also splits it over 'model').

The other cells on a mesh (dense prefill and decode, GNN, recsys) raise
``NotImplementedError`` (ROADMAP.md, Queue 1 item 8.11).
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
    expert_mesh: Optional[tf_mod.ExpertMesh] = None
    # the sharded cells' mesh, and their leaves' logical axes and whole
    # shapes (the dense LM train cell on a mesh)
    mesh: Any = None
    state_logical: Any = None
    state_whole: Any = None
    batch_logical: Optional[Dict[str, Any]] = None

    def state_shardings(self, zero1: bool = True):
        """The state's placements (a tree of ``sharding.Placement``), m
        and v under ZeRO-1 with ``zero1``; None off a mesh."""
        if self.mesh is None or self.state_logical is None:
            return None
        return _placements(self.mesh, self.state_logical, self.state_whole,
                           zero1)

    def batch_shardings(self):
        """The batch's placements; None off a mesh."""
        if self.mesh is None or self.batch_logical is None:
            return None
        return {k: shd.named_sharding(self.batch_logical[k], shape,
                                      self.mesh)
                for k, (shape, _) in self.batch_shapes.items()}


def _placements(mesh, logical, whole, zero1: bool = True):
    """The placements of a state of ``logical`` axes and ``whole`` shapes
    on ``mesh``; with ``zero1`` m and v under ``zero1_spec``."""
    out = shd.tree_shardings(logical, whole, mesh)
    if zero1 and "opt" in out:
        for mv in ("m", "v"):
            out["opt"][mv] = _map2(
                lambda p, shape: shd.Placement(
                    mesh, shd.zero1_spec(p.spec, shape, mesh)),
                out["opt"][mv], whole["opt"][mv])
    return out


def _map2(fn, tree, other):
    """``fn`` over the leaves of ``tree`` and the matching entries of
    ``other`` (dicts by key)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
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


def _masked_ce(logits, labels):
    """Mean cross-entropy over the nodes whose label is >= 0."""
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, lab[:, None])[:, 0]
    return torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1)


def _gnn_cell(cfg: GNNConfig, shape, opt_cfg: OptConfig):
    i32, f32 = torch.int32, torch.float32
    d = cfg.d_hidden
    if shape.kind in ("full_graph", "minibatch"):
        if shape.kind == "full_graph":
            n, m = _pad(shape.n_nodes), _pad(shape.n_edges)
        else:
            n, m = _gnn_subgraph_sizes(shape)
        batch_shapes = {"feats": ((n, shape.d_feat), f32),
                        "src": ((m,), i32), "dst": ((m,), i32),
                        "labels": ((n,), i32)}

        def loss_fn(p, batch):
            logits = gnn_mod.forward_full(cfg, p, batch["feats"],
                                          batch["src"], batch["dst"], n)
            return _masked_ce(logits, batch["labels"])

        # 3x fwd-cost (fwd+bwd); per layer: edge msgs (m*d) + dense (n*d*d)
        flops_fn = lambda: 3 * cfg.n_layers * (2 * m * d + 2 * n * d * d) \
            + 3 * 2 * n * shape.d_feat * d                       # noqa: E731
        return _train_step(opt_cfg, loss_fn), batch_shapes, None, flops_fn

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
        return _train_step(opt_cfg, loss_fn), batch_shapes, None, flops_fn
    raise ValueError(shape.kind)


# --------------------------------------------------------------- recsys ----

def _recsys_cell(cfg: RecsysConfig, shape, opt_cfg: OptConfig):
    Lh = cfg.hist_len
    D, K = cfg.embed_dim, cfg.n_interests
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "train":
        B = shape.batch
        batch_shapes = {"hist_ids": ((B, Lh), i32),
                        "hist_mask": ((B, Lh), f32),
                        "target": ((B,), i32),
                        "negatives": ((B, cfg.n_negatives), i32)}
        flops_fn = lambda: 3 * B * (                               # noqa: E731
            2 * Lh * D * D + cfg.capsule_iters * 4 * K * Lh * D
            + 2 * (1 + cfg.n_negatives) * D)
        step = _train_step(
            opt_cfg, lambda p, batch: rec_mod.train_loss(cfg, p, batch))
        return step, batch_shapes, None, flops_fn

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


def _mesh_grad_norm(cfg: LMConfig, grads, ep):
    """The float32 L2 norm of the whole model's gradient on a mesh: each
    model rank's own expert leaves summed over the model group, every
    other leaf (the same on every rank) counted once."""
    split = tf_mod.expert_slices(cfg, ep) is not None
    lay = grads["layers"]
    own = [lay[k] for k in tf_mod.EXPERT_LEAVES] if split else []
    shared = [v for k, v in grads.items() if k != "layers"] + [
        v for k, v in lay.items()
        if not (split and k in tf_mod.EXPERT_LEAVES)]

    def sq(ts):
        return sum(torch.sum(torch.square(t.float())) for t in ts)
    total = sq(shared)
    if own:
        total = total + all_reduce_(sq(own), ep.mesh.model_group)
    return torch.sqrt(total)


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
                   loss_chunk: int = 16384, ep=None):
    mb = max(1, cfg.microbatches)
    D = ep.mesh.n_data if ep is not None else 1
    if B % (mb * D):
        raise ValueError(f"batch {B} does not split into {mb} microbatches"
                         f" over {D} data ranks")

    def step(state, batch):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        if ep is not None:
            tokens = _data_block(tokens, D, ep.mesh.d, mb)
            labels = _data_block(labels, D, ep.mesh.d, mb)
        loss, grads = _accumulate(cfg, params, tokens, labels, mb,
                                  loss_chunk, ep)
        gnorm = None
        if ep is not None:
            # each data rank's loss is the mean over its own block
            group = ep.mesh.data_group
            for leaf in _leaves(grads):
                all_reduce_(leaf, group).div_(D)
            loss = all_reduce_(loss.clone(), group) / D
            gnorm = _mesh_grad_norm(cfg, grads, ep)
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"], gnorm=gnorm)
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


def _lm_mesh_train_step(cfg: LMConfig, opt_cfg: OptConfig, B: int, mesh,
                        placements, loss_chunk: int = 16384):
    """The dense LM train step on ``mesh`` (the module docstring), over
    states placed by ``placements`` (``CellSpec.state_shardings()``)."""
    mb = max(1, cfg.microbatches)
    n_dp, i_dp = mesh.size(mesh.dp_axes), mesh.index(mesh.dp_axes)
    dp_group = mesh.group(mesh.dp_axes)
    if B % (mb * n_dp):
        raise ValueError(f"batch {B} does not split into {mb} microbatches"
                         f" over {n_dp} data ranks")
    p_specs = [p.spec for p in _leaves(placements["params"])]
    m_specs = [p.spec for p in _leaves(placements["opt"]["m"])]
    tp = tf_mod.tensor_parallel(cfg, mesh, _map(
        lambda p: p.spec, placements["params"]))
    # each leaf's group for the clipping norm: the axes it is split over
    norm_groups = [mesh.group(shd.spec_axes(spec)) for spec in p_specs]
    # ZeRO-1: the dim m and v split further over the data axes
    shards, zero_axes = zip(*(
        _zero1_block(shape, ps, ms, mesh) for shape, ps, ms in zip(
            _leaves(tf_mod.param_shapes(cfg)), p_specs, m_specs)))

    def step(state, batch):
        params = state["params"]
        tokens = _data_block(batch["tokens"], n_dp, i_dp, mb)
        labels = _data_block(batch["labels"], n_dp, i_dp, mb)
        loss, grads = _accumulate(cfg, params, tokens, labels, mb,
                                  loss_chunk, tp=tp)
        if dp_group is not None:
            # each data rank's loss is the mean over its own block
            for leaf in _leaves(grads):
                all_reduce_(leaf, dp_group, "grad_sum").div_(n_dp)
            loss = all_reduce_(loss.clone(), dp_group, "loss") / n_dp
        gnorm = _sharded_grad_norm(grads, norm_groups)
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"], gnorm=gnorm,
                                            shards=shards)
        for p, sh, axes in zip(_leaves(params), shards, zero_axes):
            if sh is not None:            # ZeRO-1: the updated blocks
                p.copy_(all_gather_(p.narrow(*sh), mesh.group(axes),
                                    sh[0], mesh.members(axes),
                                    name="zero1_gather"))
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return step


def _gather_rows(t, mesh, dim: int):
    """The data ranks' blocks of ``t`` along ``dim``, in rank order."""
    return mesh.gather_data(t.movedim(dim, 0)).movedim(0, dim)


def _lm_state_logical(cfg: LMConfig):
    """(logical axes, whole shapes) of a dense LM train state."""
    p_log = tf_mod.param_logical_axes(cfg)
    p_shape = tf_mod.param_shapes(cfg)
    logical = {"params": p_log, "opt": {"m": p_log, "v": p_log,
                                        "step": ()}}
    whole = {"params": p_shape, "opt": {"m": p_shape, "v": p_shape,
                                        "step": ()}}
    return logical, whole


def _lm_cell(cfg: LMConfig, shape, opt_cfg: OptConfig, ep=None,
             mesh=None):
    B, S = shape.batch, shape.seq_len
    i32 = torch.int32

    if shape.kind == "train":
        batch_shapes = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
        if mesh is not None:
            placements = _placements(mesh, *_lm_state_logical(cfg))
            return _lm_mesh_train_step(cfg, opt_cfg, B, mesh,
                                       placements), batch_shapes
        return _lm_train_step(cfg, opt_cfg, B, ep=ep), batch_shapes

    if shape.kind == "prefill":
        batch_shapes = {"tokens": ((B, S), i32)}
        sharded = ep is not None and ep.tokens_sharded

        def step(state, batch):
            tokens = batch["tokens"]
            if sharded:
                tokens = _data_block(tokens, ep.mesh.n_data, ep.mesh.d, 1)
            logits, cache = tf_mod.prefill(cfg, state["params"], tokens, S,
                                           ep)
            if sharded:
                logits = _gather_rows(logits, ep.mesh, 0)
                cache = {k: _gather_rows(v, ep.mesh, 1)
                         for k, v in cache.items()}
            return state, {"logits": logits, "cache": cache}

        return step, batch_shapes

    if shape.kind == "decode":
        batch_shapes = {"token": ((B, 1), i32), "pos": ((), i32)}

        def step(state, batch):
            # the cache is updated in place (transformer.decode_step)
            logits, cache = tf_mod.decode_step(
                cfg, state["params"], state["cache"], batch["token"],
                batch["pos"], ep)
            return {"params": state["params"], "cache": cache}, logits

        return step, batch_shapes
    raise ValueError(shape.kind)


def _expert_mesh(shape, mesh) -> tf_mod.ExpertMesh:
    """An MoE LM cell's ``ExpertMesh`` on ``mesh``: decode keeps the whole
    batch on every rank and splits the experts' mlp dim over the data
    ranks (the reference's ``{"mlp": "data"}`` for MoE decode); train and
    prefill take the data rank's block of the batch, but a prefill batch
    the data ranks do not divide stays whole (the reference's
    ``tokens_sharded`` rule)."""
    if shape.kind == "decode":
        return tf_mod.ExpertMesh(mesh, tokens_sharded=False,
                                 mlp_over_data=True)
    whole = shape.kind == "prefill" and shape.batch % mesh.n_data
    return tf_mod.ExpertMesh(mesh, tokens_sharded=not whole)


def _ferrari_cell(cfg: FerrariServeConfig, shape, opt_cfg: OptConfig,
                  mesh=None):
    """Phase-1 classification over the gather-fused layout: state ``slab``
    [n, 2K] (begins with exact flags in the sign bits, then ends) and
    ``meta`` [n, 4] (π | blevel << 24, τ, s⁺, s⁻) int32, from
    ``PackedIndex.to_torch(device, fused=True)``; batch ``cs``, ``ct`` [Q]
    int32 condensed ids. Kernel 1 on a card, its plain version on the
    CPU (the reference's cell runs its plain rules, ``use_pallas=False``).

    Sharded (``index_placement="sharded"`` and a ``mesh`` whose model axis
    M divides n): the state is the rank's n / M rows
    (``core.distributed.shard_tables``), every rank takes the whole batch
    and the step is ``classify_sharded``, which returns the whole verdict
    on every rank."""
    from ..kernels import ops
    n, K = cfg.n_nodes, cfg.k_max
    i32 = torch.int32
    Q = _pad(shape.n_queries)
    sharded = (getattr(cfg, "index_placement", "replicated") == "sharded"
               and mesh is not None and n % mesh.n_model == 0)
    rows = n // mesh.n_model if sharded else n
    state_shapes = {"slab": ((rows, 2 * K), i32), "meta": ((rows, 4), i32)}
    batch_shapes = {"cs": ((Q,), i32), "ct": ((Q,), i32)}

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


def build_cell(cfg, shape_name: str, device="cuda", shape_override=None,
               opt_cfg: OptConfig | None = None, mesh=None) -> CellSpec:
    """The (arch, shape) cell on ``device``. ``mesh``: a
    ``launch.mesh.Mesh`` (or ``core.distributed.ServingMesh``) for the
    dense LM train cell's sharded step, the ferrari cell's sharded
    placement or the MoE LM cells' expert parallelism (its device is then
    the cell's); the other cells run on one device and refuse one. This
    rank must be in the mesh."""
    shape = shape_override or shapes_for_family(cfg.family)[shape_name]
    kw = {}
    if mesh is not None:
        lm = cfg.family == "lm"
        if not (cfg.family == "ferrari" or (lm and cfg.moe is not None)
                or (lm and shape.kind == "train")):
            raise NotImplementedError(
                f"the {cfg.family} {shape.kind} cells of {cfg.arch_id} run "
                "on one device; the dense LM train cell, the ferrari cell "
                "and the MoE LM cells take a mesh (the others: ROADMAP.md, "
                "Queue 1 item 8.11)")
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is not in {mesh!r}")
        if cfg.family == "ferrari":
            kw["mesh"] = mesh
        elif cfg.moe is not None:
            if set(mesh.axis_names) != {"data", "model"}:
                raise NotImplementedError(
                    "the MoE LM cells take a (data, model) mesh")
            kw["ep"] = _expert_mesh(shape, mesh)
        else:
            kw["mesh"] = mesh
        device = mesh.device
    dev = resolve_device(device)
    step, batch_shapes, *extra = _CELLS[cfg.family](cfg, shape,
                                                    opt_cfg or OptConfig(),
                                                    **kw)
    state_shapes, flops_fn = extra if extra else (None, None)
    sharded = {}
    if cfg.family == "lm" and "mesh" in kw:
        logical, whole = _lm_state_logical(cfg)
        sharded = dict(mesh=mesh, state_logical=logical, state_whole=whole,
                       batch_logical={"tokens": ("batch", None),
                                      "labels": ("batch", None)})
    return CellSpec(arch=cfg.arch_id, shape_name=shape_name, kind=shape.kind,
                    step=step, batch_shapes=batch_shapes, device=dev,
                    shape=shape, state_shapes=state_shapes,
                    model_flops_fn=flops_fn, expert_mesh=kw.get("ep"),
                    **sharded)


def _sharded_lm_state(cell: CellSpec, cfg, gen: torch.Generator):
    mesh, placements = cell.mesh, cell.state_shardings()

    def block(whole, p):
        part = shd.local_slice(whole, p.spec, mesh)
        return part if part.shape == whole.shape else part.clone()
    params = _map2(block, tf_mod.init_params(cfg, gen, cell.device),
                   placements["params"])

    def zeros(p, shape):
        return torch.zeros(shd.local_shape(shape, p.spec, mesh),
                           dtype=torch.float32, device=cell.device)
    opt = {mv: _map2(zeros, placements["opt"][mv],
                     cell.state_whole["opt"][mv]) for mv in ("m", "v")}
    opt["step"] = torch.zeros((), dtype=torch.int32)
    return {"params": params, "opt": opt}


def materialize_state(cell: CellSpec, cfg, shape_name: str,
                      gen: torch.Generator):
    """Real (allocated) state on the cell's device, drawn from ``gen`` (a
    generator on that device); on a mesh, every rank draws the whole
    params from the same seed and keeps its own experts (MoE) or its
    blocks of every leaf (the dense train cell: ``cell.state_shardings``,
    m and v zeros of their ZeRO-1 blocks' shapes)."""
    if cell.state_logical is not None:
        return _sharded_lm_state(cell, cfg, gen)
    if cfg.family == "recsys":
        state = {"params": rec_mod.init_params(cfg, gen, cell.device)}
        if cell.kind == "train":
            state["opt"] = adamw_init(state["params"])
        return state
    if cfg.family == "gnn":
        shape = cell.shape
        p = gnn_mod.init_params(cfg, gen, shape.d_feat, shape.n_classes,
                                cell.device)
        return {"params": p, "opt": adamw_init(p)}
    if cfg.family == "lm":
        state = {"params": tf_mod.shard_experts(
            cfg, tf_mod.init_params(cfg, gen, cell.device),
            cell.expert_mesh)}
        if cell.kind == "train":
            state["opt"] = adamw_init(state["params"])
        if cell.kind == "decode":
            state["cache"] = tf_mod.init_cache(cfg, cell.shape.batch,
                                               cell.shape.seq_len,
                                               cell.device)
        return state
    if cfg.family == "ferrari":
        raise ValueError("use core.packed.PackedIndex for real ferrari state")
    raise ValueError(cfg.family)
