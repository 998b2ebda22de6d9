"""The entry points the engine and the models use: the reachability ops
over a ``PackedIndex.to_torch`` dict, and the float substrate ops of the
GNN, recsys and LM models.

Each op dispatches by the tensors' device only: on the CPU the kernels'
plain PyTorch versions run; on a CUDA device the hand-written kernels
launch, or the call raises. No option selects the plain versions while a
card is present.

``segment_mp`` and ``embedding_bag`` stand for no Pallas kernel: the
reference computes them with ``jax.ops.segment_*`` outside any kernel,
and here they are ``index_add`` / ``scatter_reduce`` on either device.
Ids must lie in range: where JAX drops or clamps an id out of range,
PyTorch raises (or asserts on the card).
"""
from __future__ import annotations

import torch

from . import ref
from .batched_mp import batched_mp  # noqa: F401  (kernel 9, differentiable)
from .flash_attention import flash_attention
from .frontier_fused import emit_plain, expand_frontier_loop_fused
from .interval_stab import stab_naive, stab_packed, stab_packed_owned
from .retrieval_score import retrieval_score  # noqa: F401  (kernel 10)

NEG, POS, UNKNOWN = ref.NEG, ref.POS, ref.UNKNOWN


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Flash attention. q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd], KV
    dividing H (GQA: head h reads kv head h // (H / KV), in place) →
    [B, Sq, H, hd] in q's dtype. Kernel 6 on a card, its plain float32
    softmax on the CPU; the backward is kernels 7 and 8."""
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def classify_queries(dev: dict, cs, ct):
    """Phase-1 verdict [Q] int32 of condensed-id pairs (cs, ct) [Q] int32,
    cs == ct folded to POS. Kernel 1 on the fused slab/meta layout,
    kernel 2 on the 12-array layout.

    The pre-fetched form (``dev["_prefetched"]``, the sharded placement's
    compute-at-owner step): ``meta_t`` [Q, 4] holds t's meta rows from the
    owned-rows exchange, ``meta`` / ``slab`` this rank's shard from node id
    ``base`` on; kernel 1's owned-rows entry reads the source's rows there
    and returns the verdict where the rank owns cs, else 0."""
    if dev.get("_prefetched"):
        return stab_packed_owned(dev["meta_t"], dev["meta"], dev["slab"],
                                 cs, ct, dev["base"])
    if "slab" in dev:
        return stab_packed(dev["meta"], dev["slab"], cs, ct)
    sp, sm = ref.naive_seed_rows(dev)
    return stab_naive(dev["pi"], dev["tau"], dev["blevel"], dev["begins"],
                      dev["ends"], dev["exact"], sp, sm, cs, ct)


def classify_all_nodes_vs_target(dev: dict, ct, can_reach_tail=None):
    """Dense phase-2 helper: classify EVERY node u against each target of
    ``ct`` [Q] through the phase-1 kernel on the [Q·n] pairs. Returns
    (expandable [Q, n] bool, definite_pos [Q, n] bool): expandable nodes
    have an approximate hit and pass every negative filter; reaching a
    definite-positive node (exact hit, seed-positive, or u == t) proves
    the query. ``can_reach_tail`` ([n] bool, a live overlay's) keeps
    base-NEG nodes expandable while they can still reach a delta-edge
    tail."""
    n, q = dev["pi"].shape[0], ct.shape[0]
    cs_all = torch.arange(n, dtype=torch.int32, device=ct.device).repeat(q)
    v = classify_queries(dev, cs_all, ct.repeat_interleave(n)).view(q, n)
    expandable = v == UNKNOWN
    if can_reach_tail is not None:
        expandable |= (v == NEG) & can_reach_tail[None, :]
    return expandable, v == POS


def frontier_classify(dev: dict):
    """The sparse loop's survivor verdicts on the 12-array layout: kernel 2
    on (cands, tgts), which gathers its own rows, then the emit rule; None
    on the fused layout, where kernel 4 classifies from the meta/slab rows
    in place."""
    if "slab" in dev:
        return None
    sp, sm = ref.naive_seed_rows(dev)
    tables = (dev["pi"], dev["tau"], dev["blevel"], dev["begins"],
              dev["ends"], dev["exact"], sp, sm)

    def classify(cands, tgts, keys, eq):
        # kernel 2 folds cands == tgts to POS itself (eq)
        return emit_plain(stab_naive(*tables, cands, tgts), keys)
    return classify


def expand_frontier(dev: dict, ell, tail_src, tail_dst, is_hub, cs, ct,
                    pad, *, max_steps: int, cap: int, workspaces=None,
                    can_reach_tail=None):
    """Sparse phase-2 expansion of one chunk of UNKNOWN queries over the
    ELL + tail layout, on one device: (pos [Q] bool on the host,
    overflow bool). Under overflow, positives are sound and the caller
    retries the rest with a larger cap. The chunk is bounded by
    ``frontier.max_batch(n)``. ``workspaces`` (required on a card): a
    dict that keeps the loop's device state across calls
    (``frontier_fused.StepState``). ``can_reach_tail``: a live overlay's
    gate for kernel 4's overlay rule (``expand_frontier_overlay``).

    The fused layout classifies survivors with kernel 4 from the meta/slab
    rows in place; the 12-array layout (multi-word seeds or n > 2**24)
    with ``frontier_classify``'s kernel 2, and overflows by the
    reference's XLA-loop rule (more than ``cap`` distinct survivors),
    which is the loop the reference runs there."""
    fused = "slab" in dev
    return expand_frontier_loop_fused(
        ell, tail_src, tail_dst, is_hub, cs, ct, pad,
        n_nodes=ell.shape[0], max_steps=max_steps, cap=cap,
        classify=frontier_classify(dev),
        tables={"meta": dev["meta"], "slab": dev["slab"]} if fused else None,
        distinct_overflow=not fused, can_reach_tail=can_reach_tail,
        workspaces=workspaces)


def expand_frontier_overlay(dev: dict, ell, tail_src, tail_dst, is_hub,
                            can_reach_tail, cs, ct, pad, *, max_steps: int,
                            cap: int, workspaces=None):
    """Union-graph (base + delta slab) expansion for live-update serving
    (``reach.dynamic``): ``expand_frontier`` over the union tail
    (``tail_src``/``tail_dst`` with the delta slab appended, ``is_hub``
    extended to the delta tails) with kernel 4's overlay rule on
    ``can_reach_tail`` ([n] bool; None: no overlay). ``max_steps`` must
    bound the union BFS depth (callers pass n: delta edges may close
    cycles over the base DAG). On the fused layout this is kernels 3 and
    4, one CUDA graph a call; on the 12-array layout kernel 2 gives the
    verdicts the rule then reads."""
    return expand_frontier(dev, ell, tail_src, tail_dst, is_hub, cs, ct, pad,
                           max_steps=max_steps, cap=cap,
                           workspaces=workspaces,
                           can_reach_tail=can_reach_tail)


# ------------------------------------------------------------ torch ops
# Substrate ops of the GNN and recsys models (no Pallas kernel in the
# reference either: ``jax.ops.segment_*`` there).

class _SegmentSum(torch.autograd.Function):
    """Σ of x's rows into n segments by ids (``index_add``); the backward
    gathers the gradient at the ids. ``index_add``'s own backward keeps
    x, the [m, F] messages, alive until the backward; this one keeps only
    the ids (at ogb_products' 61.9M edges × 128 that is 31.7 GB less)."""

    @staticmethod
    def forward(ctx, x, ids, n: int):
        ctx.save_for_backward(ids)
        out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        return out.index_add_(0, ids, x)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return torch.index_select(grad, 0, ids), None, None


def _segment_sum(x, ids, n: int):
    return _SegmentSum.apply(x, ids, n)


def segment_mp(x_src, dst_ids, n_nodes: int, reduce: str = "sum"):
    """Message passing via edge-gather + segment reduction.

    x_src: [m, F] gathered source features; dst_ids: [m] targets in
    [0, n_nodes). ``max`` leaves an empty segment at -inf (the scatter's
    identity, as ``jax.ops.segment_max`` does); ``mean`` at 0."""
    if reduce == "sum":
        return _segment_sum(x_src, dst_ids, n_nodes)
    if reduce == "max":
        lowest = (float("-inf") if x_src.dtype.is_floating_point
                  else torch.iinfo(x_src.dtype).min)
        out = torch.full((n_nodes, *x_src.shape[1:]), lowest,
                         dtype=x_src.dtype, device=x_src.device)
        idx = dst_ids.long().view(-1, *([1] * (x_src.dim() - 1)))
        return out.scatter_reduce(0, idx.expand_as(x_src), x_src, "amax")
    if reduce == "mean":
        s = _segment_sum(x_src, dst_ids, n_nodes)
        c = _segment_sum(x_src.new_ones((x_src.shape[0], 1)), dst_ids,
                         n_nodes)
        return s / torch.clamp(c, min=1.0)
    raise ValueError(reduce)


def embedding_bag(table, ids, bag_ids, n_bags: int, weights=None,
                  mode: str = "sum"):
    """EmbeddingBag: gather rows + segment-reduce into bags.

    table: [V, D]; ids: [L] flat item ids; bag_ids: [L] bag assignment;
    weights: optional [L] per-row weights."""
    rows = torch.index_select(table, 0, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return _segment_sum(rows, bag_ids, n_bags)
    if mode == "mean":
        s = _segment_sum(rows, bag_ids, n_bags)
        c = _segment_sum(rows.new_ones((ids.shape[0], 1)), bag_ids, n_bags)
        return s / torch.clamp(c, min=1.0)
    raise ValueError(mode)
