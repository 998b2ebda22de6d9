"""Plain PyTorch oracles of the kernels: the phase-1 verdict rules and
the two float substrate kernels (dense message passing, retrieval scores).

Each function mirrors ``repro/kernels/ref.py`` on the natural [Q, ...]
layout. The verdict rules are all int32 (uint32 seed words ride as int32
views: ``&``, ``|``, ``~`` and ``!= 0`` give the same bits), so the port is
held to them by exact equality; the float oracles by a stated tolerance.
"""
from __future__ import annotations

import torch

NEG, POS, UNKNOWN = 0, 1, 2


def _verdict(pos, neg):
    return torch.where(pos, POS, torch.where(neg, NEG, UNKNOWN)).to(
        torch.int32)


def interval_stab_classify_ref(tgt_pi, tau_s, tau_t, lvl_s, lvl_t,
                               begins, ends, exact,
                               sp_s, sm_s, sp_t, sm_t):
    """Oracle of the 12-operand stab kernel: [Q] / [Q, K] / [Q, W] rows."""
    pt = tgt_pi[:, None]
    hit = (begins <= pt) & (pt <= ends)                    # [Q, K]
    hit_exact = (hit & (exact != 0)).any(dim=1)
    hit_any = hit.any(dim=1)

    neg = tau_s >= tau_t
    neg |= lvl_s <= lvl_t
    seed_pos = ((sp_s & sm_t) != 0).any(dim=1)
    neg |= ((sm_s & ~sm_t) != 0).any(dim=1)
    neg |= ((sp_t & ~sp_s) != 0).any(dim=1)

    neg |= ~hit_any
    return _verdict(hit_exact | seed_pos, neg)


def interval_stab_classify_packed_ref(meta_s, meta_t, slab_s):
    """Oracle of the gather-fused layout: meta rows [Q, 4] (word0 = π |
    min(blevel, 255) << 24, τ, s⁺, s⁻) and slab rows [Q, 2K] (begins with
    the exact flag in the sign bit, then ends). A saturated source level
    suppresses the level filter."""
    k = slab_s.shape[1] // 2
    braw = slab_s[:, :k]
    ends = slab_s[:, k:]
    begins = braw & 0x7FFFFFFF
    exact = braw < 0

    pt = meta_t[:, 0:1] & 0xFFFFFF                          # π(t)
    hit = (begins <= pt) & (pt <= ends)                     # [Q, K]
    hit_exact = (hit & exact).any(dim=1)
    hit_any = hit.any(dim=1)

    lvl_s = (meta_s[:, 0] >> 24) & 0xFF
    lvl_t = (meta_t[:, 0] >> 24) & 0xFF
    neg = meta_s[:, 1] >= meta_t[:, 1]                      # τ filter (Eq.11)
    neg |= (lvl_s < 255) & (lvl_s <= lvl_t)                 # level filter
    sp_s, sm_s = meta_s[:, 2], meta_s[:, 3]
    sp_t, sm_t = meta_t[:, 2], meta_t[:, 3]
    seed_pos = (sp_s & sm_t) != 0
    neg |= (sm_s & ~sm_t) != 0
    neg |= (sp_t & ~sp_s) != 0

    neg |= ~hit_any
    return _verdict(hit_exact | seed_pos, neg)


def naive_seed_rows(dev: dict):
    """(s⁺, s⁻) tables of the 12-array layout; [n, 0] when seeds are off
    (no seed rule fires, exactly as the reference's all-zero words)."""
    if "s_plus" in dev:
        return dev["s_plus"], dev["s_minus"]
    z = dev["pi"].new_zeros((dev["pi"].shape[0], 0))
    return z, z


def classify_packed_dev_ref(dev: dict, cs, ct):
    """Classify condensed-id pairs against a ``PackedIndex.to_torch`` dict:
    the fused slab/meta layout when present, else the 12-array layout,
    with the cs == ct early positive."""
    s, t = cs.long(), ct.long()
    if "slab" in dev:
        meta, slab = dev["meta"], dev["slab"]
        v = interval_stab_classify_packed_ref(meta[s], meta[t], slab[s])
    else:
        pi, tau, lvl = dev["pi"], dev["tau"], dev["blevel"]
        sp, sm = naive_seed_rows(dev)
        v = interval_stab_classify_ref(
            pi[t], tau[s], tau[t], lvl[s], lvl[t],
            dev["begins"][s], dev["ends"][s], dev["exact"][s],
            sp[s], sm[s], sp[t], sm[t])
    return torch.where(cs == ct, POS, v).to(torch.int32)


def batched_mp_ref(adj, x, w):
    """Oracle for kernels.batched_mp: per-graph dense message passing.

    adj: [B, N, N] float (adj[b, i, j] = edge j->i weight or 0)
    x:   [B, N, F] node features
    w:   [F, H] projection applied after aggregation
    Returns [B, N, H] = (adj @ x) @ w.
    """
    agg = torch.einsum("bnm,bmf->bnf", adj, x)
    return torch.einsum("bnf,fh->bnh", agg, w)


def retrieval_score_ref(cands, interests):
    """Oracle for kernels.retrieval_score: MIND multi-interest retrieval.

    cands: [C, D] candidate item embeddings
    interests: [I, D] user interest capsules
    Returns [C] = max_i <cand, interest_i>  (MIND serving argmax-interest).
    """
    return (cands @ interests.T).amax(dim=1)
