"""Decoder-only LM (llama family), dense and MoE variants: GQA, RoPE,
SwiGLU FFN, and an int8 KV cache.

Layer parameters are stacked on a leading ``layers`` axis with the
reference's names and layouts (``wq [L, D, H·hd]``, ``w_gate [L, D, F]``,
or ``[L, E, D, F]`` with a float32 ``router [L, D, E]`` for MoE, …); the
layer loop is a Python loop over ``params["layers"][name][i]`` (or over
a list of per-layer dicts: ``layer_leaves``). Prefill and training run
flash attention (kernel 6 on a card, kernels 7 and 8 in the backward)
once per layer through ``chunked_attention``; decode runs the plain
masked softmax over the cache. ``logits_and_loss`` is the training loss,
a chunked and checkpointed cross-entropy; with ``cfg.remat`` the forward
recomputes each layer in the backward.

On a mesh whose model axis is wider than one rank, the train and
prefill paths run tensor-parallel (``TensorParallel``,
``tensor_parallel``):
each rank holds the reference's block of every leaf
(``param_logical_axes`` through ``parallel.sharding.logical_to_spec``)
and attends with the heads the reference's ``_expand_kv`` gives it
(kv heads the model ranks do not divide expanded to the query heads,
query heads they do not divide zero-padded to the next multiple and
the padded ones sliced off before ``wo``); a stored block of ``wq``,
``wk``, ``wv`` or ``wo`` that is not the columns those heads need is
re-sliced over the model group first (``parallel.gather_from_group``).
The q/k/v and gate/up projections are column-parallel and ``wo`` and
``w_down`` row-parallel (``parallel.copy_to_group`` on the normed
input, ``sum_over_group`` on the output); the embedding is
vocab-parallel (a masked lookup of the rank's rows, summed over the
group), and so is the loss (``_VocabChunkLoss``). An MoE config's
attention splits the same way, beside its experts over the model ranks.
Decode on a mesh makes q, k and v whole from the column blocks and
attends over the rank's block of the cache's sequence, the partial
softmaxes combined over the sequence's ranks (flash-decoding,
``CacheShard``, ``attention.decode_attention``). The MoE FFN takes a
mesh (``ExpertMesh`` over a ``launch.mesh.Mesh``): with
``moe.impl == "shard_map"`` each model rank runs its E / M experts and
the partial combines are summed over the model group
(``_moe_ffn_expert_parallel``, the reference's ``_moe_ffn_shardmap``);
without a mesh it is the reference's gather path (``_moe_ffn_gather``),
as the reference's is without one.

The MoE FFN is capacity-based top-K routing in small steps that the
tests hold one by one (``route``, ``queue_positions``,
``dispatch_tables``, ``expert_ffn``, ``combine``), every discrete choice
the reference's: top-K ties go to the lower expert index (a stable
descending sort; ``torch.topk`` orders ties otherwise), queue positions
in the flat token-major order, assignments past the capacity dropped.
Everything but those choices is differentiable: the gates through the
softmax and the sort, the gather of the tokens, the three GEMMs and the
combine, which sums each token's K slots in k order (no atomics).
With ``cfg.kv_cache_dtype == "int8"`` the decode cache holds int8 keys
and values with float32 absmax scales per (token, kv head);
``prefill`` returns its cache in the model's dtype, as the reference's
does, and ``quantize_cache`` re-encodes it for ``decode_step``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..parallel.collectives import (all_gather_, all_reduce_,
                                    copy_to_group, gather_from_group,
                                    sum_over_group)
from ..parallel.sharding import logical_to_spec, spec_axes
from .attention import chunked_attention, decode_attention
from .common import normal_init, rms_norm, rope_tables, rotate

LAYER_LEAVES = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate",
                "w_up", "w_down")
MOE_LAYER_LEAVES = LAYER_LEAVES + ("router",)
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")     # [L, E, ...] in an MoE layer


def param_logical_axes(cfg: LMConfig) -> dict:
    """The reference's logical axes of every leaf of the params tree."""
    lay = {
        "attn_norm": ("layers", "embed"),
        "mlp_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
    }
    if cfg.moe:
        lay.update({
            "router": ("layers", "embed", "experts"),
            "w_gate": ("layers", "experts", "embed", "mlp"),
            "w_up": ("layers", "experts", "embed", "mlp"),
            "w_down": ("layers", "experts", "mlp", "embed"),
        })
    else:
        lay.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    tree = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            "layers": lay}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    return tree


def param_shapes(cfg: LMConfig) -> dict:
    """The whole shape of every leaf of the params tree (no allocation)."""
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    lay = {"attn_norm": (L, D), "mlp_norm": (L, D), "wq": (L, D, H * hd),
           "wk": (L, D, KV * hd), "wv": (L, D, KV * hd),
           "wo": (L, H * hd, D)}
    if cfg.moe:
        E = cfg.moe.n_experts
        lay.update(router=(L, D, E), w_gate=(L, E, D, F_),
                   w_up=(L, E, D, F_), w_down=(L, E, F_, D))
    else:
        lay.update(w_gate=(L, D, F_), w_up=(L, D, F_), w_down=(L, F_, D))
    tree = {"embed": (V, D), "final_norm": (D,), "layers": lay}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (D, V)
    return tree


def init_params(cfg: LMConfig, gen: torch.Generator, device):
    """The reference's params tree with its scales, drawn from ``gen`` (a
    generator on ``device``): norms at 1, projections N(0, 1)·fan_in^-1/2,
    the embedding N(0, 1); for MoE the router in float32 whatever
    ``cfg.dtype`` is, and the experts' [L, E, ...] weights drawn a layer
    at a time (the float32 draw of a whole stack would be 35 GB at
    moonshot's widths)."""
    dt = getattr(torch, cfg.dtype)
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    s_in = D ** -0.5

    def normal(shape, scale):
        return normal_init(gen, shape, scale, dt, device)

    def stacked(shape, scale):
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], scale)
        return out

    lay = {
        "attn_norm": torch.ones((L, D), dtype=dt, device=device),
        "mlp_norm": torch.ones((L, D), dtype=dt, device=device),
        "wq": normal((L, D, H * hd), s_in),
        "wk": normal((L, D, KV * hd), s_in),
        "wv": normal((L, D, KV * hd), s_in),
        "wo": normal((L, H * hd, D), (H * hd) ** -0.5),
    }
    if cfg.moe:
        E = cfg.moe.n_experts
        lay["router"] = normal_init(gen, (L, D, E), s_in, torch.float32,
                                    device)
        lay.update(w_gate=stacked((L, E, D, F_), s_in),
                   w_up=stacked((L, E, D, F_), s_in),
                   w_down=stacked((L, E, F_, D), F_ ** -0.5))
    else:
        lay.update(w_gate=normal((L, D, F_), s_in),
                   w_up=normal((L, D, F_), s_in),
                   w_down=normal((L, F_, D), F_ ** -0.5))
    params = {"embed": normal((V, D), 1.0),
              "final_norm": torch.ones((D,), dtype=dt, device=device),
              "layers": lay}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), s_in)
    return params


def _layer_params(params, i: int) -> dict:
    layers = params["layers"]
    if isinstance(layers, list):                 # per-layer leaves
        return layers[i]
    return {name: leaf[i] for name, leaf in layers.items()}


def layer_leaves(params) -> dict:
    """``params`` with its stacked layer leaves split into a list of
    per-layer dicts of views, each view a fresh autograd leaf, as is every
    other leaf. Differentiating with respect to them gives each layer's
    gradient by itself: the autograd of ``stacked[i]`` would instead write
    a zero-filled gradient of the whole stack for every layer and leaf."""
    def leaf(t):
        return t.detach().requires_grad_()
    out = {name: leaf(t) for name, t in params.items() if name != "layers"}
    n = params["layers"][LAYER_LEAVES[0]].shape[0]
    out["layers"] = [{name: leaf(t[i])
                      for name, t in params["layers"].items()}
                     for i in range(n)]
    return out


def _head(cfg: LMConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _dense_ffn(lp, x):
    h = F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])
    return h @ lp["w_down"]


# ---------------------------------------------------------------- MoE FFN --

def capacity(moe, G: int) -> int:
    """Slots an expert takes of ``G`` tokens: the reference's
    ``max(int(G·K / E · capacity_factor), 1)``, the same float
    expression."""
    return max(int(G * moe.top_k / moe.n_experts * moe.capacity_factor), 1)


def route(moe, router, xf):
    """Top-K routing of ``xf [G, D]``: (gates [G, K] float32, the K
    probabilities renormalised to sum 1; experts [G, K] int64). The logits
    are ``xf`` in float32 times the float32 router, softmaxed in float32.
    The K largest come from a stable descending sort, so that equal
    probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :moe.top_k], top_e[:, :moe.top_k]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_e


def queue_positions(flat_e, n_experts: int):
    """The rank of each assignment ``flat_e [G·K]`` (token-major, then k)
    within its expert's queue, in that flat order: the reference's
    ``"sort"`` dispatch (a stable argsort, then each expert's start by
    ``searchsorted``), which gives the ``"cumsum"`` dispatch's
    positions."""
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=flat_e.dtype,
                               device=flat_e.device))
    pos_sorted = (torch.arange(flat_e.numel(), device=flat_e.device)
                  - starts[sorted_e])
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def dispatch_tables(gates, experts, n_experts: int, cap: int, e0: int = 0,
                    n_local: int | None = None):
    """The [E_loc, C] token table (int64) and gate table (float32) of a
    routing over experts ``e0 .. e0 + E_loc - 1`` (``n_local`` = E_loc,
    default all ``n_experts``), and the slot [G, K] (int64) of each
    assignment: assignment (g, k) of a local expert e goes to slot ((e −
    e0)·C + pos) at its queue position pos, unless pos >= C, when it is
    dropped; a dropped assignment, or one to an expert of another rank,
    takes the sentinel slot E_loc·C. An empty slot holds token 0 with gate
    0. Queue positions count every expert's assignments in the flat order,
    as the reference's ``_expert_ffn_local`` does."""
    G, K = experts.shape
    n_local = n_experts if n_local is None else n_local
    dev = experts.device
    flat_e = experts.reshape(-1)
    pos = queue_positions(flat_e, n_experts)
    rel = flat_e - e0
    keep = (rel >= 0) & (rel < n_local) & (pos < cap)
    slot = torch.where(keep, rel * cap + pos, n_local * cap)
    tokens = torch.arange(G, device=dev).repeat_interleave(K)
    token_of = torch.zeros(n_local * cap + 1, dtype=torch.int64,
                           device=dev).scatter_(0, slot, tokens)
    gate_of = torch.zeros(n_local * cap + 1, dtype=torch.float32,
                          device=dev).scatter_(0, slot, gates.reshape(-1))
    return (token_of[:-1].view(n_local, cap),
            gate_of[:-1].view(n_local, cap), slot.view(G, K))


def expert_ffn(lp, ex_in):
    """SwiGLU of each expert over its slots: ``ex_in [E, C, D]`` → [E, C,
    D], batched GEMMs over the experts."""
    h = F.silu(torch.bmm(ex_in, lp["w_gate"])) * torch.bmm(ex_in, lp["w_up"])
    return torch.bmm(h, lp["w_down"])


def combine(ex_out, gate_tbl, slot):
    """[G, D] in ``ex_out``'s dtype: each slot's output times its gate
    (rounded to that dtype), token g's K slots ``slot[g]`` summed in k
    order in that dtype, the sentinel slot adding nothing. The reference's
    ``segment_sum`` over the [E, C] table, in a fixed order: no atomics,
    so a step gives the same bits on every run, and the backward is a
    gather of the slots (it keeps only ``slot``)."""
    E, C, D = ex_out.shape
    weighted = ex_out * gate_tbl[..., None].to(ex_out.dtype)
    rows = torch.cat([weighted.reshape(E * C, D),
                      weighted.new_zeros((1, D))])[slot]      # [G, K, D]
    out = rows[:, 0]
    for k in range(1, slot.shape[1]):
        out = out + rows[:, k]
    return out


def _expert_ffn_local(moe, router, lp, xf, cap: int, e0: int, n_local: int):
    """Route the tokens ``xf [G, D]``, keep the assignments to experts
    ``e0 .. e0 + n_local − 1`` (whose stacks ``lp`` holds), and return
    their gate-weighted outputs combined per token, [G, D] in the experts'
    dtype: the whole FFN when the rank holds every expert, else this
    rank's partial sum."""
    gates, experts = route(moe, router, xf)
    token_tbl, gate_tbl, slot = dispatch_tables(
        gates, experts, moe.n_experts, cap, e0, n_local)
    return combine(expert_ffn(lp, xf[token_tbl]), gate_tbl, slot)


def _moe_ffn_gather(cfg: LMConfig, lp, x):
    """Capacity-based top-K routing, the experts' batched GEMMs over the
    [E, C] token table, the gate-weighted combine: x [B, S, D] → [B, S,
    D] in x's dtype."""
    moe = cfg.moe
    B, S, D = x.shape
    G = B * S
    out = _expert_ffn_local(moe, lp["router"], lp, x.reshape(G, D),
                            capacity(moe, G), 0, moe.n_experts)
    return out.reshape(B, S, D).to(x.dtype)


# ----------------------------------------------------- expert parallelism --

@dataclass(frozen=True)
class ExpertMesh:
    """How the MoE FFN runs over a ``core.distributed.ServingMesh``: the
    experts split over the model ranks, E / M each. ``tokens_sharded``:
    x is this data rank's block of the batch (train, prefill) and the
    capacity is per data shard, as GShard's; else x is the whole batch on
    every rank (decode) and the capacity global, with the experts' mlp
    dim also split over the data ranks when ``mlp_over_data``.
    ``stored``: where the state holds the reference's blocks of the
    router and the expert stacks (a cell's state on a mesh), each layer
    leaf's spec (its spec without the layers entry); the router, split
    over the experts' axis, is gathered whole before routing, and every
    stack is gathered whole where the gather path runs. None: the router
    whole and the stacks this rank's (``expert_slices``)."""
    mesh: object
    tokens_sharded: bool = True
    mlp_over_data: bool = False
    stored: dict | None = None

    def axes(self) -> tuple:
        """The mesh axes the combine is summed over."""
        return ("model", "data") if self.mlp_over_data else ("model",)

    def groups(self) -> list:
        """The process groups the combine is summed over (groups of one
        rank left out)."""
        over = [self.mesh.group(a) for a in self.axes()]
        return [g for g in over if g is not None]


def expert_slices(cfg: LMConfig, ep: ExpertMesh | None):
    """(expert slice, mlp slice) of this rank's expert stacks under
    ``ep``, or None where the gather path runs: no mesh, ``moe.impl`` not
    "shard_map", or the model ranks not dividing the experts (the
    reference's own fallback)."""
    if ep is None or cfg.moe is None or cfg.moe.impl != "shard_map":
        return None
    m, E = ep.mesh, cfg.moe.n_experts
    if E % m.n_model:
        return None
    e_loc = E // m.n_model
    experts = slice(m.m * e_loc, (m.m + 1) * e_loc)
    if not ep.mlp_over_data:
        return experts, slice(None)
    if cfg.d_ff % m.n_data:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over the "
                         f"{m.n_data} data ranks")
    f_loc = cfg.d_ff // m.n_data
    return experts, slice(m.d * f_loc, (m.d + 1) * f_loc)


def _moe_ffn_expert_parallel(cfg: LMConfig, lp, x, ep: ExpertMesh):
    """The reference's ``_moe_ffn_shardmap`` on this rank: every token of
    ``x`` routed, the assignments to the rank's E / M experts
    (``lp``'s stacks, ``expert_slices``) run, and the partial combine, in
    the activations' dtype, summed over the model group (and the data
    group when the mlp dim is split there). ``x`` and the router enter
    through ``copy_to_group`` over the same groups, so that their
    gradients, partial on each rank, are summed as ``shard_map``
    transposes a replicated input."""
    moe, mesh = cfg.moe, ep.mesh
    B, S, D = x.shape
    G = B * S
    e_loc = moe.n_experts // mesh.n_model
    xf, router = x.reshape(G, D), lp["router"]
    split = ()
    if ep.stored is not None:            # its gradient summed and cut
        router = unsplit(router, ep.stored["router"], mesh)
        split = spec_axes(ep.stored["router"])
    for a in ep.axes():
        g = mesh.group(a)
        xf = copy_to_group(xf, g)
        if a not in split:
            router = copy_to_group(router, g)
    out = _expert_ffn_local(moe, router, lp, xf, capacity(moe, G),
                            mesh.m * e_loc, e_loc).to(x.dtype)
    for g in ep.groups():
        out = sum_over_group(out, g)
    return out.reshape(B, S, D)


def _moe_ffn(cfg: LMConfig, lp, x, ep: ExpertMesh | None = None):
    """The reference's dispatcher: expert-parallel with ``impl=
    "shard_map"`` and a mesh, the gather path otherwise (on a mesh, over
    the rank's own tokens)."""
    if expert_slices(cfg, ep) is not None:
        return _moe_ffn_expert_parallel(cfg, lp, x, ep)
    if ep is not None and ep.stored is not None:
        # every rank of a model group runs the same FFN on the same
        # tokens: the whole stacks' gradient is whole on each
        lp = {**lp, **{name: unsplit(lp[name], spec, ep.mesh, partial=False)
                       for name, spec in ep.stored.items()}}
    return _moe_ffn_gather(cfg, lp, x)


def unsplit(leaf, spec, mesh, partial: bool = True):
    """The whole of a leaf that this rank holds as its block under
    ``spec``: gathered over the ranks of each split dimension
    (``parallel.gather_from_group``: the gradient of the whole, partial
    on each rank, summed over them and cut to the block; with
    ``partial`` False whole on each rank, and only cut)."""
    for dim, entry in enumerate(spec):
        if entry is not None and mesh.size(entry) > 1:
            leaf = gather_from_group(leaf, mesh.group(entry), dim,
                                     mesh.members(entry), mesh.index(entry),
                                     partial)
    return leaf


# ------------------------------------------------------ tensor parallelism --

@dataclass(frozen=True)
class TensorParallel:
    """How the dense layer runs over the model ranks of a mesh
    (``tensor_parallel``): ``group`` and ``ranks`` (its global ranks in
    block order), this rank's ``index`` on the model axis; ``heads``
    (h0, h1, n_pad): it attends with query heads h0 .. h1 − 1 and n_pad
    zero heads after them; ``expand``: k and v expanded to one head a
    query head; ``stored``: for ``wq``, ``wk``, ``wv`` (last dim) and
    ``wo`` (first dim of a layer's) the (lo, hi, whole) of the block this
    rank holds of the dim the heads split; ``vocab`` / ``head_vocab``:
    the (v0, v1) rows of the embedding / columns of the output head it
    holds, None where they are whole; ``mlp``: the FFN is a
    column/row-parallel pair over the group (else whole on every
    rank)."""
    group: object
    ranks: tuple
    index: int
    heads: tuple
    expand: bool
    stored: dict
    vocab: tuple | None
    head_vocab: tuple | None
    mlp: bool


def _model_block(spec, shape, dim: int, mesh):
    """(lo, hi, whole) of this rank's block of ``dim`` under ``spec``,
    which may split it over the model axis only."""
    entry, whole = spec[dim], shape[dim]
    if entry is None or mesh.size(entry) == 1:
        return (0, whole, whole)
    if entry != "model":
        raise ValueError(f"tensor parallelism splits over 'model' only, "
                         f"not {entry!r}")
    b = whole // mesh.size(entry)
    i = mesh.index(entry)
    return (i * b, (i + 1) * b, whole)


def tensor_parallel(cfg: LMConfig, mesh, specs: dict):
    """The layer's ``TensorParallel`` on ``mesh`` for the params'
    ``specs`` (``parallel.sharding.logical_to_spec`` of
    ``param_logical_axes``); None on a model axis of one rank. An MoE
    config's attention splits the same way and its FFN stays on the
    ``ExpertMesh`` (``mlp`` False). The
    heads follow the reference's ``_expand_kv``: with M model ranks, H
    query heads are padded to hp = ⌈H / M⌉·M when M does not divide H,
    kv heads are expanded when H ≠ KV and M does not divide KV (or heads
    are padded), and rank m takes padded heads m·hp/M .. (m+1)·hp/M − 1.
    A rank may hold only padded heads (smollm-360m's 15 over 16 ranks):
    its share of the attention is zero, and it takes part in every
    collective of the layer as the others do."""
    M = mesh.n_model
    if M == 1:
        return None
    H, KV = cfg.n_heads, cfg.n_kv_heads
    hp = 0 if H % M == 0 else -(-H // M) * M
    nh = (hp or H) // M
    h0 = min(mesh.m * nh, H)
    h1 = min(h0 + nh, H)
    shapes = param_shapes(cfg)
    lay, lsh = specs["layers"], shapes["layers"]
    stored = {name: _model_block(lay[name], lsh[name], 2, mesh)
              for name in ("wq", "wk", "wv")}
    stored["wo"] = _model_block(lay["wo"], lsh["wo"], 1, mesh)

    def vocab_of(spec, shape, dim):
        lo, hi, whole = _model_block(spec, shape, dim, mesh)
        return None if (lo, hi) == (0, whole) else (lo, hi)
    vocab = vocab_of(specs["embed"], shapes["embed"], 0)
    head_vocab = vocab if cfg.tie_embeddings else vocab_of(
        specs["lm_head"], shapes["lm_head"], 1)
    split = [False]                # the MoE FFN runs on ExpertMesh
    if cfg.moe is None:
        mlp = [_model_block(lay[n], lsh[n], d, mesh)
               for n, d in (("w_gate", 2), ("w_up", 2), ("w_down", 1))]
        split = [(lo, hi) != (0, whole) for lo, hi, whole in mlp]
        if len(set(split)) != 1:
            raise ValueError("w_gate, w_up and w_down must split d_ff alike")
    return TensorParallel(
        group=mesh.group("model"), ranks=tuple(mesh.members("model")),
        index=mesh.index("model"), heads=(h0, h1, nh - (h1 - h0)),
        expand=H != KV and (KV % M != 0 or hp > 0), stored=stored,
        vocab=vocab, head_vocab=head_vocab, mlp=split[0])


def _take(tp: TensorParallel, leaf, name: str, dim: int, a: int, b: int):
    """Columns (rows, for ``dim`` 0) a .. b − 1 of the whole of layer
    leaf ``name``, from the block this rank stores: the block itself
    where it is those, a part of a replicated leaf whose gradient is
    summed over the group (the other ranks use other parts), else a
    part of the whole gathered over the group."""
    lo, hi, whole = tp.stored[name]
    if (lo, hi) == (a, b):
        return leaf
    if (lo, hi) == (0, whole):
        return copy_to_group(leaf, tp.group).narrow(dim, a, b - a)
    return gather_from_group(leaf, tp.group, dim, tp.ranks,
                             tp.index).narrow(dim, a, b - a)


def _attention_tp(cfg: LMConfig, lp, x, cos, sin, tp: TensorParallel):
    """This rank's heads' share of the attention block's output [B, S,
    D], summed over the model group."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    h0, h1, n_pad = tp.heads
    nq = h1 - h0
    k0, k1 = h0 // G, -(-h1 // G)          # the kv heads those heads read
    h = copy_to_group(rms_norm(x, lp["attn_norm"], cfg.norm_eps), tp.group)
    wq = _take(tp, lp["wq"], "wq", 1, h0 * hd, h1 * hd)
    wk = _take(tp, lp["wk"], "wk", 1, k0 * hd, k1 * hd)
    wv = _take(tp, lp["wv"], "wv", 1, k0 * hd, k1 * hd)
    q = rotate((h @ wq).reshape(B, S, nq, hd), cos, sin)
    k = rotate((h @ wk).reshape(B, S, k1 - k0, hd), cos, sin)
    v = (h @ wv).reshape(B, S, k1 - k0, hd)
    if tp.expand:                          # one kv head a query head
        idx = torch.arange(h0, h1, device=x.device) // G - k0
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    if n_pad:                              # zero heads, sliced off below
        q, k, v = (F.pad(t, (0, 0, 0, n_pad)) for t in (q, k, v))
    att = chunked_attention(q, k, v, causal=True)[:, :, :nq]
    wo = _take(tp, lp["wo"], "wo", 0, h0 * hd, h1 * hd)
    return sum_over_group(att.reshape(B, S, nq * hd) @ wo, tp.group)


def _dense_ffn_tp(lp, x, tp: TensorParallel):
    if not tp.mlp:
        return _dense_ffn(lp, x)
    return sum_over_group(_dense_ffn(lp, copy_to_group(x, tp.group)),
                          tp.group)


def _layer_tp(cfg: LMConfig, lp, x, cos, sin, tp: TensorParallel,
              ep=None):
    x = x + _attention_tp(cfg, lp, x, cos, sin, tp)
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe:
        return x + _moe_ffn(cfg, lp, h2, ep)
    return x + _dense_ffn_tp(lp, h2, tp)


def _embed(params, tokens, tp: TensorParallel | None = None):
    """The embedding rows of ``tokens``: vocab-parallel under ``tp`` (each
    rank looks up the tokens whose rows it holds, zeros for the others,
    summed over the group)."""
    if tp is None or tp.vocab is None:
        return params["embed"][tokens.long()]
    v0, v1 = tp.vocab
    local = tokens.long() - v0
    own = (local >= 0) & (local < v1 - v0)
    x = params["embed"][local.clamp(0, v1 - v0 - 1)]
    return sum_over_group(x.masked_fill(~own[..., None], 0), tp.group)


def _qkv(cfg: LMConfig, lp, x, cos, sin, tp=None):
    """Normed, projected and rotated q [B, S, H, hd], k, v [B, S, KV, hd];
    under ``tp`` from this rank's column blocks of wq, wk, wv, the
    products gathered whole over the model group (``_columns``: decode's
    q reaches every rank with all its heads, as SPMD gathers it for the
    cache's sequence-split attention)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)

    def proj(name):
        y = h @ lp[name]
        return y if tp is None else _columns(tp, y, name)
    q = proj("wq").reshape(B, S, H, hd)
    k = proj("wk").reshape(B, S, KV, hd)
    v = proj("wv").reshape(B, S, KV, hd)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _finish_layer(cfg: LMConfig, lp, x, att, ep=None, tp=None):
    """Output projection, residual, FFN, residual; under ``tp`` (decode)
    ``wo`` row-parallel where this rank holds a block of its rows, and
    the dense FFN a column/row-parallel pair."""
    B, S = x.shape[:2]
    att = att.reshape(B, S, cfg.n_heads * cfg.hd)
    lo, hi, whole = tp.stored["wo"] if tp is not None else (0, 0, 0)
    if (lo, hi) == (0, whole):
        x = x + att @ lp["wo"]
    else:
        x = x + sum_over_group(att[..., lo:hi] @ lp["wo"], tp.group)
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe:
        return x + _moe_ffn(cfg, lp, h2, ep)
    return x + (_dense_ffn(lp, h2) if tp is None
                else _dense_ffn_tp(lp, h2, tp))


def _layer(cfg: LMConfig, lp, x, cos, sin, ep=None):
    """One layer over a prompt: (new x, its k and v [B, S, KV, hd])."""
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    att = chunked_attention(q, k, v, causal=True)
    return _finish_layer(cfg, lp, x, att, ep), k, v


def _positions(B: int, S: int, device, start: int = 0):
    return (start + torch.arange(S, dtype=torch.int32, device=device)
            ).expand(B, S)


def _layer_out(cfg: LMConfig, lp, x, cos, sin, ep=None, tp=None):
    if tp is not None:
        return _layer_tp(cfg, lp, x, cos, sin, tp, ep)
    return _layer(cfg, lp, x, cos, sin, ep)[0]


def forward(cfg: LMConfig, params, tokens, ep: ExpertMesh | None = None,
            tp: TensorParallel | None = None):
    """tokens [B, S] → final hidden states [B, S, D]. With ``cfg.remat``
    each layer is checkpointed (the reference's ``jax.checkpoint`` of its
    scanned body): the backward recomputes it from its input, routing
    included (the stable sort routes it the same). ``ep``: the MoE FFN's
    expert parallelism (``ExpertMesh``), ``tp``: the dense layer's tensor
    parallelism (``TensorParallel``, over this rank's blocks of the
    params); None on one device."""
    B, S = tokens.shape
    x = _embed(params, tokens, tp)
    cos, sin = rope_tables(_positions(B, S, tokens.device), cfg.hd,
                           cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if cfg.remat:
            x = checkpoint(_layer_out, cfg, lp, x, cos, sin, ep, tp,
                           use_reentrant=False)
        else:
            x = _layer_out(cfg, lp, x, cos, sin, ep, tp)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


class _ChunkLoss(torch.autograd.Function):
    """Σ weight · (logsumexp − the label's logit) over one chunk of rows;
    the product rounds to the params' dtype before the float32 softmax,
    as the reference's einsum does. The backward recomputes the chunk's
    float32 logits and turns them into their gradient in place, (softmax
    − one-hot) · weight · g, rounded to the params' dtype: it holds one
    [chunk, V] float32 buffer where autograd of the same expression under
    a checkpoint holds three or four (at 16,384 rows × 163,840 vocab each
    is 10.7 GB)."""

    @staticmethod
    def forward(ctx, h, head, labels, weight):
        logits = (h @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, 1, labels[:, None])[:, 0]
        ctx.save_for_backward(h, head, labels, weight, lse)
        return torch.sum((lse - ll) * weight)

    @staticmethod
    def backward(ctx, g):
        h, head, labels, weight, lse = ctx.saved_tensors
        d = (h @ head).float()
        d.sub_(lse[:, None]).exp_()
        d.scatter_add_(1, labels[:, None],
                       torch.full_like(lse[:, None], -1.0))
        d.mul_((weight * g)[:, None])
        d = d.to(h.dtype)
        return d @ head.T, h.T @ d, None, None


class _VocabChunkLoss(torch.autograd.Function):
    """``_ChunkLoss`` over logits whose vocab is split over a group: this
    rank holds columns v0 .. v0 + V_loc − 1 of the head. The row max is
    reduced over the group (max), then the sum of exps and the label's
    logit together (sum; only the rank that holds the label's column
    adds it), so every rank returns the whole chunk's loss. The backward
    turns this rank's block of the logits, and no more, into its
    gradient in place, as ``_ChunkLoss`` does; h's gradient is this
    rank's part (summed by ``copy_to_group`` on h)."""

    @staticmethod
    def forward(ctx, h, head, labels, weight, v0, group):
        logits = (h @ head).float()
        n = logits.shape[1]
        local = labels - v0
        own = ((local >= 0) & (local < n)).float()
        local = local.clamp(0, n - 1)
        mx = all_reduce_(logits.amax(dim=-1), group, "loss_max",
                         op=dist.ReduceOp.MAX)
        parts = torch.stack([
            torch.exp(logits - mx[:, None]).sum(dim=-1),
            torch.gather(logits, 1, local[:, None])[:, 0] * own])
        all_reduce_(parts, group, "loss_sum")
        lse = torch.log(parts[0]) + mx
        ctx.save_for_backward(h, head, local, own, weight, lse)
        return torch.sum((lse - parts[1]) * weight)

    @staticmethod
    def backward(ctx, g):
        h, head, local, own, weight, lse = ctx.saved_tensors
        d = (h @ head).float()
        d.sub_(lse[:, None]).exp_()
        d.scatter_add_(1, local[:, None], -own[:, None])
        d.mul_((weight * g)[:, None])
        d = d.to(h.dtype)
        return d @ head.T, h.T @ d, None, None, None, None


def logits_and_loss(cfg: LMConfig, params, tokens, labels,
                    loss_chunk=16384, ep: ExpertMesh | None = None,
                    tp: TensorParallel | None = None):
    """Mean next-token cross-entropy of ``tokens [B, S]`` against ``labels
    [B, S]``, float32. The [B·S, V] logits are produced and reduced chunk
    by chunk (rows padded to a multiple of ``loss_chunk`` with weight 0),
    the backward recomputing each chunk's [chunk, V] logits instead of
    keeping them (``_ChunkLoss``; ``_VocabChunkLoss`` over this rank's
    columns of a vocab-parallel head under ``tp``). ``loss_chunk=None``:
    one chunk."""
    hs = forward(cfg, params, tokens, ep, tp)
    vocab = tp.head_vocab if tp is not None else None
    if vocab is not None:
        hs = copy_to_group(hs, tp.group)
    B, S, D = hs.shape
    G = B * S
    chunk = min(loss_chunk or G, G)
    nc = -(-G // chunk)
    pad = nc * chunk - G
    hf = F.pad(hs.reshape(G, D), (0, 0, 0, pad))
    lf = F.pad(labels.reshape(G).long(), (0, pad))
    wmask = F.pad(torch.ones(G, dtype=torch.float32, device=hs.device),
                  (0, pad))
    head = _head(cfg, params)
    total = torch.zeros((), dtype=torch.float32, device=hs.device)
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        if vocab is None:
            total = total + _ChunkLoss.apply(hf[rows], head, lf[rows],
                                             wmask[rows])
        else:
            total = total + _VocabChunkLoss.apply(
                hf[rows], head, lf[rows], wmask[rows], vocab[0], tp.group)
    return total / G


def _dense_cache(cfg: LMConfig, batch: int, max_seq: int, device):
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device):
    """KV cache of zeros: ``{"k", "v"}`` [L, B, max_seq, KV, hd] in the
    model's dtype, or with ``cfg.kv_cache_dtype == "int8"`` int8 ``k``,
    ``v`` and their float32 absmax scales ``k_scale``, ``v_scale`` [L, B,
    max_seq, KV]."""
    if cfg.kv_cache_dtype != "int8":
        return _dense_cache(cfg, batch, max_seq, device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}


def _quantize_token(x):
    """x [..., hd] → (int8 values, float32 absmax scales [...]): scale =
    max|x| / 127, at least 1e-8; values x / scale rounded half to even
    and clipped to ±127. Both are true divisions, on a card too: there a
    division by a Python number is a product with its reciprocal, which
    can round the scale differently, so 127 is a tensor on x's device."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_cache(cache):
    """A cache in the model's dtype (``prefill``'s) re-encoded as the int8
    cache ``decode_step`` reads for an int8 config, a layer at a time
    (the float32 copy of a whole cache would be 4x its bytes)."""
    out = {}
    for name in ("k", "v"):
        x = cache[name]
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        s = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        for i in range(x.shape[0]):
            q[i], s[i] = _quantize_token(x[i])
        out[name], out[f"{name}_scale"] = q, s
    return out


def _logits(cfg: LMConfig, params, x, tp: TensorParallel | None = None):
    """[B, 1, D] → float32 logits [B, V]; under ``tp`` this rank's vocab
    columns of the head, gathered over the model group."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = (x @ _head(cfg, params))[:, 0].float()
    if tp is not None and tp.head_vocab is not None:
        out = all_gather_(out, tp.group, 1, tp.ranks, "logits")
    return out


# ------------------------------------------------------ the cache on a mesh --

def cache_logical_axes(cfg: LMConfig) -> dict:
    """The reference's logical axes of the decode cache's leaves."""
    ax = ("layers", "batch", "kv_seq", "kv_heads", None)
    out = {"k": ax, "v": ax}
    if cfg.kv_cache_dtype == "int8":
        out["k_scale"] = out["v_scale"] = ax[:-1]
    return out


def cache_shapes(cfg: LMConfig, batch: int, max_seq: int) -> dict:
    """The whole shape of every leaf of ``init_cache``'s cache."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    out = {"k": shape, "v": shape}
    if cfg.kv_cache_dtype == "int8":
        out["k_scale"] = out["v_scale"] = shape[:-1]
    return out


@dataclass(frozen=True)
class CacheShard:
    """This rank's block of a decode cache on a mesh, under the
    reference's spec (``cache_logical_axes``): sequence positions ``lo ..
    hi − 1`` of its ``max_seq``, split over the ranks of ``group`` (the
    'kv_seq' axes; None: one rank), batch rows ``rows`` (b0, b1), split
    over ``batch_group`` (the 'batch' axes), whose global ranks in block
    order are ``batch_ranks``, and kv heads ``heads`` (k0, k1), split
    over ``heads_group`` (the 'kv_heads' axis, where the sequence's axes
    do not divide it) with global ranks ``heads_ranks``; ``rows`` and
    ``heads`` None: whole."""
    lo: int
    hi: int
    group: object = None
    rows: tuple | None = None
    batch_group: object = None
    batch_ranks: tuple = ()
    heads: tuple | None = None
    heads_group: object = None
    heads_ranks: tuple = ()


def cache_shard(cfg: LMConfig, batch: int, max_seq: int, mesh,
                rules=None) -> CacheShard | None:
    """The ``CacheShard`` of this rank on ``mesh`` for a cache of
    ``batch`` × ``max_seq``; None where the spec splits neither its batch
    nor its sequence over more than one rank. A batch the data ranks
    divide takes them, and the sequence then only 'model' (the spec's
    used-axis rule); a batch of one leaves the sequence over ('data',
    'model'). kv heads stay whole (their axis is taken by the
    sequence)."""
    spec = logical_to_spec(cache_logical_axes(cfg)["k"],
                           cache_shapes(cfg, batch, max_seq)["k"], mesh,
                           rules)
    (b_ax, s_ax, h_ax), kw = spec[1:4], {}
    n = [mesh.size(a) if a is not None else 1 for a in (b_ax, s_ax, h_ax)]
    if n == [1, 1, 1]:
        return None
    if n[0] > 1:
        b, i = batch // n[0], mesh.index(b_ax)
        kw.update(rows=(i * b, (i + 1) * b), batch_group=mesh.group(b_ax),
                  batch_ranks=tuple(mesh.members(b_ax)))
    if n[2] > 1:
        h, i = cfg.n_kv_heads // n[2], mesh.index(h_ax)
        kw.update(heads=(i * h, (i + 1) * h), heads_group=mesh.group(h_ax),
                  heads_ranks=tuple(mesh.members(h_ax)))
    blk = max_seq // n[1]
    lo = mesh.index(s_ax) * blk if n[1] > 1 else 0
    return CacheShard(lo=lo, hi=lo + blk,
                      group=mesh.group(s_ax) if n[1] > 1 else None, **kw)


def _columns(tp: TensorParallel, y, name: str):
    """``y`` = x @ (this rank's block of the columns of ``name``), made
    whole: gathered over the model group where the block is not the
    whole (not differentiated; decode)."""
    lo, hi, whole = tp.stored[name]
    if (lo, hi) == (0, whole):
        return y
    return all_gather_(y, tp.group, y.dim() - 1, tp.ranks, "columns")


def _whole_columns(tp: TensorParallel, w, name: str):
    """The whole of layer leaf ``name`` [D, cols] from this rank's block
    of its columns (gathered over the model group; not differentiated;
    prefill)."""
    lo, hi, whole = tp.stored[name]
    if (lo, hi) == (0, whole):
        return w
    return all_gather_(w, tp.group, 1, tp.ranks, "weight_gather")


def _cache_kv_tp(cfg: LMConfig, lp, x, cos, sin, tp: TensorParallel):
    """The keys and values [B, n, KV, hd] of every kv head at the
    positions of ``x [B, n, D]`` (with their rope tables), for the
    cache: the whole wk and wv gathered over the model group."""
    B, n, _ = x.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    k = (h @ _whole_columns(tp, lp["wk"], "wk")).reshape(B, n, KV, hd)
    v = (h @ _whole_columns(tp, lp["wv"], "wv")).reshape(B, n, KV, hd)
    return rotate(k, cos, sin), v


def prefill(cfg: LMConfig, params, tokens, max_seq: int,
            ep: ExpertMesh | None = None, tp: TensorParallel | None = None,
            shard: CacheShard | None = None):
    """Process a full prompt tokens [B, S]: (last-token logits [B, V]
    float32, cache with the prompt's keys and values in positions < S).
    The cache is in the model's dtype for an int8 config too, as the
    reference's is (``quantize_cache`` re-encodes it).

    On a mesh: ``tp`` runs each layer tensor-parallel (``_layer_tp``, the
    train path's: kernel 6 on this rank's heads, padded and expanded as
    the reference's ``_expand_kv``), the embedding and the head
    vocab-parallel, and the logits gathered whole over the model group;
    ``shard`` cuts the returned cache to this rank's block of the
    sequence (``tokens`` is then this rank's rows of the batch where the
    shard splits it), whose keys and values take every kv head."""
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    x = _embed(params, tokens, tp)
    cos, sin = rope_tables(_positions(B, S, tokens.device), cfg.hd,
                           cfg.rope_theta)
    lo, hi = (0, max_seq) if shard is None else (shard.lo, shard.hi)
    n = max(0, min(S, hi) - lo)           # prompt positions in the block
    kv = slice(None) if shard is None or shard.heads is None \
        else slice(*shard.heads)
    cache = _dense_cache(cfg, B, hi - lo, tokens.device)
    if shard is not None and shard.heads is not None:
        cache = {k: v[:, :, :, kv].clone() for k, v in cache.items()}
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if tp is None:
            x, k, v = _layer(cfg, lp, x, cos, sin, ep)
            k, v = k[:, lo:lo + n], v[:, lo:lo + n]
        else:
            k, v = _cache_kv_tp(cfg, lp, x[:, lo:lo + n],
                                cos[:, lo:lo + n], sin[:, lo:lo + n], tp)
            x = _layer_tp(cfg, lp, x, cos, sin, tp, ep)
        cache["k"][i, :, :n] = k[:, :, kv]
        cache["v"][i, :, :n] = v[:, :, kv]
    return _logits(cfg, params, x[:, -1:], tp), cache


def decode_step(cfg: LMConfig, params, cache, token, pos,
                ep: ExpertMesh | None = None, tp: TensorParallel | None = None,
                shard: CacheShard | None = None):
    """One decode step. token [B, 1] int; pos: int (or a 0-d tensor), the
    position being decoded. Returns (logits [B, V] float32, cache).

    The cache is updated IN PLACE (this token's keys and values written at
    ``pos`` in every layer) and returned, where the reference returns a
    new one: a copy of a 32k-token cache per token would double the
    decode's memory traffic. With ``cfg.kv_cache_dtype == "int8"`` the
    cache is int8 (``init_cache``, or ``quantize_cache`` of a prefill's):
    the token's keys and values are quantized (``_quantize_token``) and
    written with their scales.

    On a mesh (flash-decoding, as the reference's SPMD partitions its
    decode over the cache's sequence): ``tp`` makes q, k and v whole from
    this rank's column blocks (``_qkv``), ``wo`` and the FFN row- and
    column-parallel and the head vocab-parallel; ``shard`` is this rank's
    block of the cache (its sequence positions, its rows of the batch,
    its kv heads). Every rank takes the whole batch of tokens; the rank
    whose block holds ``pos`` writes the token's keys, values and scales,
    each rank attends over its block with the query heads of its kv
    heads and the ranks of the shard's group combine their partial
    softmaxes (``decode_attention``), and the outputs are gathered over
    the shard's heads and batch groups."""
    pos = int(pos)
    quant = cfg.kv_cache_dtype == "int8"
    if quant and "k_scale" not in cache:
        raise ValueError(f"{cfg.arch_id} decodes from an int8 cache: "
                         "re-encode the prefill's with quantize_cache")
    B = token.shape[0]
    x = _embed(params, token, tp)                           # [B, 1, D]
    cos, sin = rope_tables(_positions(B, 1, token.device, pos), cfg.hd,
                           cfg.rope_theta)
    lo, hi = (0, cache["k"].shape[2]) if shard is None else (shard.lo,
                                                              shard.hi)
    own = lo <= pos < hi                  # this block holds position pos
    rows = slice(None) if shard is None or shard.rows is None \
        else slice(*shard.rows)
    kv = heads = slice(None)
    if shard is not None and shard.heads is not None:
        g = cfg.n_heads // cfg.n_kv_heads
        kv = slice(*shard.heads)
        heads = slice(shard.heads[0] * g, shard.heads[1] * g)
    group = None if shard is None else shard.group
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        q, k, v = _qkv(cfg, lp, x, cos, sin, tp)
        q, k, v = q[rows, :, heads], k[rows, :, kv], v[rows, :, kv]
        scales = {}
        if quant:
            (k, ks), (v, vs) = _quantize_token(k), _quantize_token(v)
            if own:
                cache["k_scale"][i, :, pos - lo] = ks[:, 0]
                cache["v_scale"][i, :, pos - lo] = vs[:, 0]
            scales = dict(k_scale=cache["k_scale"][i],
                          v_scale=cache["v_scale"][i])
        if own:
            cache["k"][i, :, pos - lo] = k[:, 0]
            cache["v"][i, :, pos - lo] = v[:, 0]
        att = decode_attention(q, cache["k"][i], cache["v"][i], pos,
                               **scales, offset=lo, group=group)
        if shard is not None and shard.heads_group is not None:
            att = all_gather_(att, shard.heads_group, 2, shard.heads_ranks,
                              "decode_heads")
        if shard is not None and shard.batch_group is not None:
            att = all_gather_(att, shard.batch_group, 0, shard.batch_ranks,
                              "decode_rows")
        x = _finish_layer(cfg, lp, x, att, ep, tp)
    return _logits(cfg, params, x, tp), cache
