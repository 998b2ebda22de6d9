"""Flash attention: kernel 6 (forward), kernels 7 and 8 (backward) and
their plain versions.

``softmax(q·kᵀ / √hd + mask) · v`` for ``q [B, Sq, H, hd]`` and ``k, v
[B, Sk, KV, hd]`` with KV dividing H (GQA: query head h reads kv head
h // G, G = H / KV, the reference's [KV, G] grouping; KV = H is plain
multi-head attention), causal from ``q_offset`` (the absolute position
of q[0]) or not, float32 or bfloat16 → ``out [B, Sq, H, hd]`` in q's
dtype and the log-sum-exp ``lse [B, H, Sq]`` float32 of each softmax row
(the backward's row statistics). The LM runs it once per layer, through
``models.attention.chunked_attention``; training runs its backward once
per layer.

  flash_fwd — kernel 6, hd 64 or 128, grouped k and v read in place. In
              bfloat16 (``csrc/flash_fwd_wgmma.cu``): one block of three
              warpgroups per (128-row q tile, b, h), K and V tiles of 128
              keys loaded by TMA into a two-stage ring, both products on
              the tensor cores (wgmma), the softmax in registers. In
              float32 (``csrc/flash_attention.cu``): one block per (b·h,
              64-row q tile), float32 FMAs on tiles in shared memory.
              Replaces the reference's ``_flash_fwd``.
  flash_bwd_dq — kernel 7: dq, grouped k and v read in place (query head
              h reads kv head h // G). In bfloat16
              (``csrc/flash_bwd_wgmma.cu``): one block of three warpgroups
              per (128-row q tile, b, h), K and V tiles streamed by TMA up
              to the diagonal, the three products on the tensor cores. In
              float32 (``csrc/flash_attention_bwd.cu``): one block per
              (b·h, 64-row q tile), float32 FMAs. Replaces the reference's
              dq ``pallas_call`` in ``_flash_vjp_bwd``.
  flash_bwd_dkv — kernel 8 (the same two files): dk and dv [B, Sk, KV,
              hd], one block per (key tile, b, kv head) looping over the G
              query heads of its kv head and their q tiles from the
              diagonal to Sq, summing the group in float32 and rounding
              once. Replaces the reference's dk/dv ``pallas_call``.
  flash_attention_plain — the full masked softmax in float32 (the
              counterpart of ``ref.flash_attention_ref``), with lse as the
              TPU kernel's ``_finish`` writes it.
  flash_bwd_plain — the backward's explicit recomputation from the saved
              out and lse, in float32, with the TPU kernels' roundings,
              dk and dv summed over each group in float32, rounded once.
  flash_attention — the ``[B, S, H, hd]`` entry point: a
              ``torch.autograd.Function`` whose forward is ``flash_fwd``
              and whose backward is ``flash_bwd`` (kernels 7 and 8), both
              on grouped k and v: no copy of k or v is made.

On a CPU tensor each wrapper runs its plain version (any head dim); on a
CUDA tensor it launches its kernel or raises; on a ``meta`` tensor (a dry
run) it checks the head dim, allocates the outputs its launch would,
records the call in ``work.TALLY`` and launches nothing. Like the TPU
kernel, the forward kernel rounds the softmax numerators to v's dtype before the
product with v and the plain version does not: they agree within 2e-5 in
float32 and 3e-2 in bfloat16. The backward's plain version makes the TPU
kernels' roundings (P to do's dtype, dS to q's and k's), so the two agree
within float32 summation order.
"""
from __future__ import annotations

import torch

from . import _lib, work
from .interval_stab import is_meta, on_cpu

NEG_INF = -1e30
HEAD_DIMS = (64, 128)           # the kernel's templates
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, q_offset: int) -> None:
    """Operands of one float dtype; k, v [B, Sk, KV, hd] with KV dividing
    q's H."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes q, k, v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention takes q [B, Sq, H, hd] and k, v "
                         f"[B, Sk, KV, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (b, _, h, hd), (bk, sk, hk, hdk) = q.shape, k.shape
    if (bk, hdk) != (b, hd) or hk < 1 or h % hk:
        raise ValueError(f"k and v must match q's batch and head dim, with "
                         f"KV dividing H (GQA) heads; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if sk < 1 or q_offset < 0:
        raise ValueError(f"flash attention takes Sk >= 1 and q_offset >= "
                         f"0; got Sk={sk}, q_offset={q_offset}")


def expand_kv(t, heads: int):
    """k or v [B, S, KV, hd] → [B, S, heads, hd]: kv head i repeated G =
    heads / KV times in place (head h reads kv head h // G)."""
    g = heads // t.shape[2]
    return t if g == 1 else t.repeat_interleave(g, dim=2)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_offset: int = 0):
    """(out [B, Sq, H, hd] in q's dtype, lse [B, H, Sq] float32): the full
    masked softmax in float32, k and v expanded to H heads."""
    _, sq, h, hd = q.shape
    sk = k.shape[1]
    k, v = expand_kv(k, h), expand_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (hd ** 0.5)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF / 2)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_fwd(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Kernel 6: (out [B, Sq, H, hd] in q's dtype, lse [B, H, Sq]
    float32) for q [B, Sq, H, hd] and k, v [B, Sk, KV, hd] (KV dividing
    H) of one dtype, float32 or bfloat16."""
    _check(q, k, v, q_offset)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    _check_head_dim(hd)
    dev = q.device
    if is_meta(q):
        work.TALLY.add("flash_fwd", (q, k, v, causal, q_offset))
        return (torch.empty_like(q),
                torch.empty((b, h, sq), dtype=torch.float32, device=dev))
    bf16 = int(q.dtype == torch.bfloat16)
    smem = _lib.LIBRARY.get().reach_flash_smem(hd, bf16)
    limit = _lib.max_smem(dev)
    if smem > limit:
        raise ValueError(f"flash attention: a block needs {smem} B of shared "
                         f"memory, the device allows {limit} B")
    name = str(q.dtype).split(".")[-1]
    args = (_lib.check(q, "q", (b, sq, h, hd), dev, 16, name),
            _lib.check(k, "k", (b, sk, kv, hd), dev, 16, name),
            _lib.check(v, "v", (b, sk, kv, hd), dev, 16, name))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if out.numel():
        _lib.launch("flash_fwd", "reach_flash_fwd", dev, *args,
                    out.data_ptr(), lse.data_ptr(), b, h, kv, sq, sk, hd,
                    bf16, int(causal), q_offset)
    return out, lse


def _bwd_plain(q, k, v, dout, lse, delta, causal: bool, q_offset: int):
    """(dq, dk, dv) float32 from the row statistics lse and delta =
    Σ_hd do·out [B, H, Sq]: the reference's ``_flash_vjp_bwd`` over the
    whole score matrix at once, on k and v expanded to H heads; dk and dv
    [B, Sk, KV, hd] are the float32 sums over each group of G heads."""
    _, sq, h, hd = q.shape
    b, sk, kv, _ = k.shape
    scale = 1.0 / (hd ** 0.5)
    k, v = expand_kv(k, h), expand_kv(v, h)
    qf, kf, dof = q.float(), k.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        p = torch.where(mask, p, 0.0)             # a select, as the TPU's
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    del dp
    # the products see P in do's dtype and dS in k's and q's, as on the TPU
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dof)
    del p
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf)
    if kv != h:
        dk, dv = (d.view(b, sk, kv, h // kv, hd).sum(3) for d in (dk, dv))
    return dq, dk, dv


def row_delta(out, dout):
    """delta [B, H, Sq] float32 = Σ_hd do·out, over the forward's output as
    rounded to q's dtype (the TPU backward's D, taken outside its kernels:
    it is O(S·hd))."""
    return torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())


def flash_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                    q_offset: int = 0):
    """(dq, dk, dv) in q's, k's and v's dtypes: the gradient of flash
    attention's out with respect to q and grouped k, v [B, Sk, KV, hd]
    for the cotangent ``dout``, recomputed in float32 from the forward's
    ``out`` and ``lse``; dk and dv sum each group of G query heads in
    float32 and are rounded once."""
    dq, dk, dv = _bwd_plain(q, k, v, dout, lse, row_delta(out, dout),
                            causal, q_offset)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, dout, lse, delta, q_offset: int) -> None:
    _check(q, k, v, q_offset)
    b, sq, h, _ = q.shape
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise TypeError(f"the flash backward takes dout of q's dtype and "
                        f"shape {tuple(q.shape)} {q.dtype}; got "
                        f"{tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, sq):
            raise TypeError(f"the flash backward takes {name} float32 "
                            f"[{b}, {h}, {sq}]; got {tuple(t.shape)} "
                            f"{t.dtype}")


def _check_head_dim(hd: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")


def _bwd_args(name, q, k, v, dout, lse, delta):
    """(device, operand pointers) after the kernel's checks: hd in
    HEAD_DIMS and the block's shared memory within the device's."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    _check_head_dim(hd)
    dev = q.device
    smem = _lib.LIBRARY.get().reach_flash_bwd_smem(
        hd, int(name == "dkv"), int(q.dtype == torch.bfloat16))
    limit = _lib.max_smem(dev)
    if smem > limit:
        raise ValueError(f"flash backward {name}: a block needs {smem} B of "
                         f"shared memory, the device allows {limit} B")
    dt = str(q.dtype).split(".")[-1]
    return dev, (_lib.check(q, "q", (b, sq, h, hd), dev, 16, dt),
                 _lib.check(k, "k", (b, sk, kv, hd), dev, 16, dt),
                 _lib.check(v, "v", (b, sk, kv, hd), dev, 16, dt),
                 _lib.check(dout, "dout", (b, sq, h, hd), dev, 16, dt),
                 _lib.check(lse, "lse", (b, h, sq), dev, 4, "float32"),
                 _lib.check(delta, "delta", (b, h, sq), dev, 4, "float32"))


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                 q_offset: int = 0):
    """Kernel 7: dq [B, Sq, H, hd] in q's dtype from q, dout [B, Sq, H,
    hd] and k, v [B, Sk, KV, hd] (KV dividing H) of one dtype (float32 or
    bfloat16), the forward's lse and ``row_delta``."""
    _check_bwd(q, k, v, dout, lse, delta, q_offset)
    if on_cpu(q):
        return _bwd_plain(q, k, v, dout, lse, delta, causal,
                          q_offset)[0].to(q.dtype)
    if is_meta(q):
        _check_head_dim(q.shape[3])
        work.TALLY.add("flash_bwd_dq",
                       (q, k, v, dout, lse, delta, causal, q_offset))
        return torch.empty_like(q)
    dev, args = _bwd_args("dq", q, k, v, dout, lse, delta)
    b, sq, h, hd = q.shape
    dq = torch.empty_like(q)
    if dq.numel():
        _lib.launch("flash_bwd_dq", "reach_flash_bwd_dq", dev, *args,
                    dq.data_ptr(), b, h, k.shape[2], sq, k.shape[1], hd,
                    int(q.dtype == torch.bfloat16), int(causal), q_offset)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                  q_offset: int = 0):
    """Kernel 8: (dk, dv) [B, Sk, KV, hd] in k's and v's dtype from q,
    dout [B, Sq, H, hd] and k, v [B, Sk, KV, hd] of one dtype, the
    forward's lse and ``row_delta``: each the float32 sum over the G query
    heads of its kv head, rounded once."""
    _check_bwd(q, k, v, dout, lse, delta, q_offset)
    if on_cpu(q):
        _, dk, dv = _bwd_plain(q, k, v, dout, lse, delta, causal, q_offset)
        return dk.to(k.dtype), dv.to(v.dtype)
    if is_meta(q):
        _check_head_dim(q.shape[3])
        work.TALLY.add("flash_bwd_dkv",
                       (q, k, v, dout, lse, delta, causal, q_offset))
        return torch.empty_like(k), torch.empty_like(v)
    dev, args = _bwd_args("dkv", q, k, v, dout, lse, delta)
    b, sq, h, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _lib.launch("flash_bwd_dkv", "reach_flash_bwd_dkv", dev, *args,
                    dk.data_ptr(), dv.data_ptr(), b, h, k.shape[2], sq,
                    k.shape[1], hd,
                    int(q.dtype == torch.bfloat16), int(causal), q_offset)
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
              q_offset: int = 0):
    """(dq, dk, dv) of flash attention for the cotangent ``dout``, k and v
    grouped [B, Sk, KV, hd]: ``flash_bwd_plain`` on the CPU; on a card
    ``row_delta``, then kernels 7 and 8."""
    if on_cpu(q):
        return flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                               q_offset=q_offset)
    delta = row_delta(out, dout)
    kw = dict(causal=causal, q_offset=q_offset)
    return (flash_bwd_dq(q, k, v, dout, lse, delta, **kw),
            *flash_bwd_dkv(q, k, v, dout, lse, delta, **kw))


class FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v); saves (q, k, v, out, lse) in the
    ``[B, S, H or KV, hd]`` / ``[B, H, Sq]`` layouts, k and v grouped, for
    the backward (``flash_bwd`` on the grouped k and v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               causal=ctx.causal, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q [B, Sq, H, hd]; k, v [B, Sk, KV, hd] (KV dividing H; GQA read in
    place) → [B, Sq, H, hd] in q's dtype. ``q_offset``: the absolute
    position of q[0] (prefill continuation)."""
    return FlashAttention.apply(q, k, v, causal, q_offset)
