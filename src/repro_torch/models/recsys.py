"""MIND: Multi-Interest Network with Dynamic routing (recsys arch).

Item embedding table → behavior-to-interest (B2I) capsule routing with a
shared bilinear map (capsule_iters=3) → label-aware attention and a
sampled softmax (train) or max-interest retrieval scoring (serve, kernel
10). The table lookups are ``index_select`` gathers (``ops.embedding_bag``
is the general form); the routing einsums run in full float32 (cuBLAS
without TF32, as PyTorch's default "highest" matmul precision gives).

Shapes: train_batch B=65536; serve 512 / 262144 users; retrieval_cand
scores one user against 10^6 candidates.

On a mesh the table's rows are split over 'model' (the reference's
``("table_rows", None)``): every lookup takes a ``TableShard`` and is a
masked lookup of the rank's rows, summed over the model group, whose
backward writes only the rank's rows (the vocab-parallel embedding's
pattern, ``transformer._embed``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import RecsysConfig
from ..kernels import ops
from ..parallel.collectives import sum_over_group
from .common import normal_init


@dataclass(frozen=True)
class TableShard:
    """This rank's rows ``lo .. hi − 1`` of the item table, split over
    the model ``group``."""
    group: object
    lo: int
    hi: int


def lookup(table, ids, shard: TableShard | None = None):
    """The table rows of ``ids`` [...] → [..., D]; under ``shard`` each
    rank looks up the ids whose rows it holds, zeros for the others, and
    the group sums them (the gradient passes to this rank's rows only)."""
    if shard is None:
        return torch.index_select(table, 0, ids.reshape(-1)).view(
            *ids.shape, table.shape[1])
    local = ids.long() - shard.lo
    own = (local >= 0) & (local < shard.hi - shard.lo)
    rows = torch.index_select(
        table, 0, local.clamp(0, shard.hi - shard.lo - 1).reshape(-1)).view(
        *ids.shape, table.shape[1])
    return sum_over_group(rows.masked_fill(~own[..., None], 0), shard.group)


def init_params(cfg: RecsysConfig, gen: torch.Generator, device):
    """The table, bilinear map and capsule bias, drawn from ``gen`` (a
    generator on ``device``) in that order."""
    dt = getattr(torch, cfg.dtype)
    D = cfg.embed_dim
    return {
        "table": normal_init(gen, (cfg.n_items, D), D ** -0.5, dt, device),
        "bilinear": normal_init(gen, (D, D), D ** -0.5, dt, device),
        "cap_bias": normal_init(gen, (cfg.n_interests, 1), 1.0,
                                torch.float32, device),
    }


def param_logical_axes(cfg: RecsysConfig) -> dict:
    """The reference's logical axes of the params' leaves."""
    return {"table": ("table_rows", None), "bilinear": (None, None),
            "cap_bias": ("capsule", None)}


def param_shapes(cfg: RecsysConfig) -> dict:
    D = cfg.embed_dim
    return {"table": (cfg.n_items, D), "bilinear": (D, D),
            "cap_bias": (cfg.n_interests, 1)}


def _squash(v):
    n2 = torch.sum(torch.square(v), dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v * torch.rsqrt(n2 + 1e-9)


def interests(cfg: RecsysConfig, params, hist_ids, hist_mask,
              shard: TableShard | None = None):
    """B2I dynamic routing. hist_ids [B, L] int32, hist_mask [B, L] f32.
    Returns interest capsules [B, K, D]."""
    B, L = hist_ids.shape
    K = cfg.n_interests
    e = lookup(params["table"], hist_ids, shard)             # [B, L, D]
    se = torch.einsum("bld,de->ble", e, params["bilinear"])  # shared map
    # routing logits [B, K, L]
    b_r = params["cap_bias"][None].expand(B, K, L).float()
    neg = (1.0 - hist_mask)[:, None, :] * -1e30
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_r + neg, dim=1)                  # over capsules
        caps = _squash(torch.einsum("bkl,ble->bke",
                                    w * hist_mask[:, None, :], se))
        b_r = b_r + torch.einsum("bke,ble->bkl", caps, se)
    return caps                                              # [B, K, D]


def label_aware_user_vec(caps, target_e, p: float = 2.0):
    """Label-aware attention (train): attend interests by target
    affinity^p. ``torch.maximum`` against a tensor, as ``jnp.maximum``:
    at a tie the gradient is split evenly."""
    att = torch.einsum("bkd,bd->bk", caps, target_e)
    floor = torch.tensor(1e-9, dtype=att.dtype, device=att.device)
    att = torch.softmax(torch.pow(torch.maximum(att, floor), p), dim=1)
    return torch.einsum("bk,bkd->bd", att, caps)


def train_loss(cfg: RecsysConfig, params, batch,
               shard: TableShard | None = None):
    """Sampled-softmax loss: the positive target against
    ``cfg.n_negatives`` uniform ids."""
    caps = interests(cfg, params, batch["hist_ids"], batch["hist_mask"],
                     shard)
    table = params["table"]
    pos_e = lookup(table, batch["target"], shard)                  # [B, D]
    neg_e = lookup(table, batch["negatives"], shard)               # [B, Nn, D]
    user = label_aware_user_vec(caps, pos_e)                       # [B, D]
    pos_s = torch.einsum("bd,bd->b", user, pos_e)
    neg_s = torch.einsum("bd,bnd->bn", user, neg_e)
    logits = torch.cat([pos_s[:, None], neg_s], dim=1).float()
    lse = torch.logsumexp(logits, dim=1)
    return torch.mean(lse - logits[:, 0])


def serve_interests(cfg: RecsysConfig, params, hist_ids, hist_mask,
                    shard: TableShard | None = None):
    return interests(cfg, params, hist_ids, hist_mask, shard)


def retrieval_scores(cfg: RecsysConfig, params, caps, cand_ids,
                     shard: TableShard | None = None):
    """Score candidate items for ONE user: caps [K, D], cand_ids [C] →
    [C] (kernel 10 on a card)."""
    cand_e = lookup(params["table"], cand_ids, shard)           # [C, D]
    return ops.retrieval_score(cand_e, caps.contiguous())
