"""MIND: Multi-Interest Network with Dynamic routing (recsys arch).

Item embedding table → behavior-to-interest (B2I) capsule routing with a
shared bilinear map (capsule_iters=3) → label-aware attention and a
sampled softmax (train) or max-interest retrieval scoring (serve, kernel
10). The table lookups are ``index_select`` gathers (``ops.embedding_bag``
is the general form); the routing einsums run in full float32 (cuBLAS
without TF32, as PyTorch's default "highest" matmul precision gives).

Shapes: train_batch B=65536; serve 512 / 262144 users; retrieval_cand
scores one user against 10^6 candidates.
"""
from __future__ import annotations

import torch

from ..configs.base import RecsysConfig
from ..kernels import ops
from .common import normal_init


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


def _squash(v):
    n2 = torch.sum(torch.square(v), dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v * torch.rsqrt(n2 + 1e-9)


def interests(cfg: RecsysConfig, params, hist_ids, hist_mask):
    """B2I dynamic routing. hist_ids [B, L] int32, hist_mask [B, L] f32.
    Returns interest capsules [B, K, D]."""
    B, L = hist_ids.shape
    K = cfg.n_interests
    table = params["table"]
    e = torch.index_select(table, 0, hist_ids.reshape(-1)).view(
        B, L, table.shape[1])                                # [B, L, D]
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


def train_loss(cfg: RecsysConfig, params, batch):
    """Sampled-softmax loss: the positive target against
    ``cfg.n_negatives`` uniform ids."""
    caps = interests(cfg, params, batch["hist_ids"], batch["hist_mask"])
    table = params["table"]
    pos_e = torch.index_select(table, 0, batch["target"])          # [B, D]
    negs = batch["negatives"]
    neg_e = torch.index_select(table, 0, negs.reshape(-1)).view(
        *negs.shape, table.shape[1])                               # [B, Nn, D]
    user = label_aware_user_vec(caps, pos_e)                       # [B, D]
    pos_s = torch.einsum("bd,bd->b", user, pos_e)
    neg_s = torch.einsum("bd,bnd->bn", user, neg_e)
    logits = torch.cat([pos_s[:, None], neg_s], dim=1).float()
    lse = torch.logsumexp(logits, dim=1)
    return torch.mean(lse - logits[:, 0])


def serve_interests(cfg: RecsysConfig, params, hist_ids, hist_mask):
    return interests(cfg, params, hist_ids, hist_mask)


def retrieval_scores(cfg: RecsysConfig, params, caps, cand_ids):
    """Score candidate items for ONE user: caps [K, D], cand_ids [C] →
    [C] (kernel 10 on a card)."""
    cand_e = torch.index_select(params["table"], 0, cand_ids)   # [C, D]
    return ops.retrieval_score(cand_e, caps.contiguous())
