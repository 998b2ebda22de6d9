"""Attention: flash attention for prefill (kernel 6 on a card), direct
masked attention for decode.

The reference's ``chunked_attention`` is a ``lax.scan`` form of the
online-softmax recurrence, which it calls the portable stand-in for a
flash-attention kernel; in PyTorch a scan would be a Python loop of small
launches, so the port's keeps the signature and calls ``ops.attention``
(kernel 6) instead: the same function within float32 rounding (the
reference's ``test_flash_matches_chunked_attention_path``). In bfloat16
the kernel rounds the softmax numerators to v's dtype before the product
with v, as the reference's TPU kernel does and its scan does not.

GQA: q's H heads are grouped as [KV, G] (head h reads kv head h // G),
as in the reference; kernel 6 reads the grouped k and v in place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels import ops
from ..parallel.collectives import all_reduce_

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal: bool = True,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0, remat_blocks: bool = True):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd]; H = KV * G → [B, Sq, H, hd]
    in v's dtype.

    The grouped k and v go to ``ops.attention`` as they are: query head h
    reads kv head h // G (the reference's [KV, G] grouping), with no copy
    of k or v. ``q_offset``: the absolute position of q[0]. ``q_chunk``,
    ``kv_chunk`` and ``remat_blocks`` are accepted for the reference's
    signature and unused: the kernel picks its own tiles, and its backward
    recomputes from the saved row statistics."""
    h, kv = q.shape[2], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    out = ops.attention(q, k, v, causal=causal, q_offset=q_offset)
    return out.to(v.dtype)


def _scores(a, b):
    """float32 ``a @ b`` of two batched matrices in one dtype. A reduced-
    precision pair goes to cuBLAS with a float32 output on a card (it sums
    in float32 and rounds nothing); the CPU has no such product, so there
    the operands are widened. A ``meta`` pair (a dry run) takes the
    card's product."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type in ("cuda", "meta"):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_attention(q, k_cache, v_cache, cur_pos,
                     k_scale=None, v_scale=None, *, offset: int = 0,
                     group=None):
    """Single-token decode. q: [B, 1, H, hd]; caches: [B, S, KV, hd];
    cur_pos: int — the position being decoded (q attends to positions
    <= cur_pos). Returns [B, 1, H, hd] in the cache's dtype, or in q's for
    an int8 cache.

    Plain masked softmax over the whole cache, as in the reference (no
    Pallas kernel there). Both products read the cache as one contiguous
    [S, KV·hd] matrix: q is spread block-diagonally over the KV·hd
    columns (head (kv, g) is zero outside kv's hd columns), and of the
    [H, KV·hd] output of p·v only each head's own kv block is kept. The
    zeros add nothing, so the sums are the per-head ones; on a card this
    is one dense GEMM over the cache in place of the strided per-head
    batch that the reference's einsum becomes in PyTorch, which cuBLAS
    runs on a slower path. The scores are float32, as the reference's
    (``preferred_element_type``), with no float32 copy of the cache (see
    ``_scores``); the softmax with its additive position bias runs in
    float32, and p is rounded to v's dtype for the product with v (float32
    accumulation).

    int8 cache: ``k_scale``, ``v_scale`` [B, S, KV] float32, the
    reference's order of roundings: the cache cast to q's dtype, the
    scores times 1/√hd and then times each head's kv-head ``k_scale``,
    the float32 softmax, p times ``v_scale``, then rounded to q's dtype.

    Flash-decoding (``group``, ``offset``): the caches are this rank's
    block of a sequence split over the ranks of ``group``, positions
    ``offset ..`` of it. Each rank takes its block's three partials of
    every head in float32: the row max m of the biased scores, the sum l
    of exp(s − m), and the unnormalised p·v (exp(s − m), times
    ``v_scale`` for int8, rounded to v's dtype as above, the product
    accumulated in float32); the group reduces m by max, rescales l and
    p·v by exp(m − max) and sums both, and the output is their quotient
    rounded once to the one-device path's dtype. The order of the
    softmax's sums is not the one-device path's (within float32
    rounding); a block wholly past ``cur_pos`` adds nothing. With no
    group and no offset this is the one-device path."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache takes both k_scale and v_scale")
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    if k_scale is not None:
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)

    def per_head(x, scale):             # [B, H, S] times [B, S, KV]
        if scale is None:
            return x
        return (x.view(b, kv, g, s)
                * scale.transpose(1, 2)[:, :, None]).view(b, h, s)

    def heads(full):                    # [B, H, KV·hd] → [B, 1, H, hd]
        out = torch.diagonal(full.view(b, kv, g, kv, hd), dim1=1, dim2=3)
        return out.permute(0, 3, 1, 2).reshape(b, 1, h, hd)

    eye = torch.eye(kv, dtype=k_cache.dtype, device=q.device)
    q_spread = torch.einsum("bkgd,kj->bkgjd",
                            q.reshape(b, kv, g, hd).to(k_cache.dtype), eye)
    scores = _scores(q_spread.reshape(b, h, kv * hd),
                     k_cache.reshape(b, s, kv * hd).transpose(1, 2))
    scores = per_head(scores * (1.0 / hd ** 0.5), k_scale)      # [B, H, S]
    pos = torch.arange(s, device=q.device)
    if group is None and offset == 0:
        bias = torch.where(pos <= cur_pos, 0.0, NEG_INF)
        p = per_head(torch.softmax(scores + bias, dim=-1), v_scale)
        full = torch.matmul(p.to(v_cache.dtype),
                            v_cache.reshape(b, s, kv * hd))  # [B, H, KV·hd]
        return heads(full)
    bias = torch.where(pos + offset <= cur_pos, 0.0, NEG_INF)
    biased = scores + bias
    m = biased.amax(dim=-1, keepdim=True)                       # [B, H, 1]
    p = torch.exp(biased - m)
    parts = torch.cat([
        _scores(per_head(p, v_scale).to(v_cache.dtype),
                v_cache.reshape(b, s, kv * hd)),           # [B, H, KV·hd]
        p.sum(dim=-1, keepdim=True)], dim=-1)
    top = all_reduce_(m.clone(), group, "decode_max", op=dist.ReduceOp.MAX)
    parts.mul_(torch.exp(m - top))
    all_reduce_(parts, group, "decode_sum")
    full = parts[..., :-1] / parts[..., -1:]
    return heads(full.to(v_cache.dtype))
