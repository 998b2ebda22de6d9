"""Flash attention forward: kernel 6 and its plain version.

``softmax(q·kᵀ / √hd + mask) · v`` for ``q [B, Sq, H, hd]`` and ``k, v
[B, Sk, H, hd]`` (GQA heads already expanded), causal from ``q_offset``
(the absolute position of q[0]) or not, float32 or bfloat16 → ``out [B,
Sq, H, hd]`` in q's dtype and the log-sum-exp ``lse [B, H, Sq]`` float32
of each softmax row (the backward's row statistics). The LM's prefill
runs it once per layer, through ``models.attention.chunked_attention``.

  flash_fwd — kernel 6 (``csrc/flash_attention.cu``): one block per (b·h,
              64-row q tile), a loop over 64-key tiles up to the diagonal,
              float32 FMAs on tiles in shared memory; hd 64 or 128.
              Replaces the reference's ``_flash_fwd``.
  flash_attention_plain — the full masked softmax in float32 (the
              counterpart of ``ref.flash_attention_ref``), with lse as the
              TPU kernel's ``_finish`` writes it.
  flash_attention — the ``[B, S, H, hd]`` entry point: a
              ``torch.autograd.Function`` whose forward is ``flash_fwd``.
              Its backward on a card waits for kernels 7 and 8 (ROADMAP.md,
              Queue 2 items 2–3) and raises; on the CPU it differentiates
              the plain version.

On a CPU tensor the wrapper runs the plain version (any head dim); on a
CUDA tensor it launches the kernel or raises. Like the TPU kernel, the
kernel rounds the softmax numerators to v's dtype before the product with
v and the plain version does not: they agree within 2e-5 in float32 and
3e-2 in bfloat16.
"""
from __future__ import annotations

import torch

from . import _lib
from .interval_stab import on_cpu

NEG_INF = -1e30
HEAD_DIMS = (64, 128)           # the kernel's templates
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, q_offset: int) -> None:
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes q, k, v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention takes q [B, Sq, H, hd] and k, v "
                         f"[B, Sk, H, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (b, _, h, hd), (bk, sk, hk, hdk) = q.shape, k.shape
    if (bk, hk, hdk) != (b, h, hd):
        raise ValueError(f"k and v must match q's batch, heads and head "
                         f"dim (expand GQA heads first); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if sk < 1 or q_offset < 0:
        raise ValueError(f"flash attention takes Sk >= 1 and q_offset >= "
                         f"0; got Sk={sk}, q_offset={q_offset}")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_offset: int = 0):
    """(out [B, Sq, H, hd] in q's dtype, lse [B, H, Sq] float32): the full
    masked softmax in float32."""
    _, sq, _, hd = q.shape
    sk = k.shape[1]
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
    float32) for q [B, Sq, H, hd] and k, v [B, Sk, H, hd] of one dtype,
    float32 or bfloat16."""
    _check(q, k, v, q_offset)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    dev = q.device
    smem, limit = _lib.LIBRARY.get().reach_flash_smem(hd), _lib.max_smem(dev)
    if smem > limit:
        raise ValueError(f"flash attention: a block needs {smem} B of shared "
                         f"memory, the device allows {limit} B")
    name = str(q.dtype).split(".")[-1]
    args = (_lib.check(q, "q", (b, sq, h, hd), dev, 16, name),
            _lib.check(k, "k", (b, sk, h, hd), dev, 16, name),
            _lib.check(v, "v", (b, sk, h, hd), dev, 16, name))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if out.numel():
        _lib.launch("flash_fwd", "reach_flash_fwd", dev, *args,
                    out.data_ptr(), lse.data_ptr(), b, h, sq, sk, hd,
                    int(q.dtype == torch.bfloat16), int(causal), q_offset)
    return out, lse


class FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v); saves (q, k, v, out, lse) in the
    ``[B, S, H, hd]`` / ``[B, H, Sq]`` layouts for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, _ = ctx.saved_tensors
        if not on_cpu(q):
            raise NotImplementedError(
                "the flash attention backward (kernels 7 and 8, dq and "
                "dk/dv) is not ported to repro_torch yet (ROADMAP.md, "
                "Queue 2 items 2-3)")
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out, _ = flash_attention_plain(*leaves, causal=ctx.causal,
                                           q_offset=ctx.q_offset)
            grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None, None)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q [B, Sq, H, hd]; k, v [B, Sk, H, hd] (GQA heads expanded) →
    [B, Sq, H, hd] in q's dtype. ``q_offset``: the absolute position of
    q[0] (prefill continuation)."""
    return FlashAttention.apply(q, k, v, causal, q_offset)
