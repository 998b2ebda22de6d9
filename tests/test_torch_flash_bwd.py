"""The port's flash attention backward on the CPU against the JAX
package: ``flash_bwd_plain`` (the plain version of kernels 7 and 8)
against ``jax.vjp`` of the reference's Pallas ``flash_attention`` in
interpret mode (block 64) over the reference tests' shape sweep (causal
and full, ragged, q_offset), and with grouped k, v [B, Sk, KV, hd] (G 2,
4, 8) against ``jax.vjp`` of the reference's ``chunked_attention`` on the
grouped heads (whose dk, dv sum each group inside a float32 einsum); the
CPU paths of the two kernel wrappers and of the autograd backward against
``flash_bwd_plain``, on expanded and grouped heads. Inputs and cotangents
are numpy, from a seed.

Tolerances: float32 at rtol/atol 2e-4, the reference's own tolerance
against its oracle (the same sums in another order); bfloat16 at 3e-2 of
the gradient's largest magnitude (both sides round P and dS to bfloat16
before the products, so a rounding flipped by a float32 sum-order
difference moves an element by 2^-8 of itself).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models.attention import chunked_attention as ref_chunked
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import (_bwd_plain,
                                                 flash_attention, flash_bwd,
                                                 flash_bwd_dkv, flash_bwd_dq,
                                                 flash_bwd_plain, flash_fwd,
                                                 row_delta)

pytestmark = pytest.mark.arch

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 3e-2

SHAPES = [
    # (b, sq, sk, h, hd, causal, q_offset): the reference test's sweep
    (1, 128, 128, 2, 64, True, 0),
    (2, 256, 256, 1, 128, True, 0),
    (1, 130, 190, 2, 64, True, 0),       # ragged
    (1, 64, 512, 1, 64, False, 0),       # cross-attention style
    (2, 64, 256, 2, 64, True, 192),      # continuation: q at offset
    (1, 96, 96, 3, 128, False, 0),
]
IDS = ["-".join(map(str, s)) for s in SHAPES]


def _mk(shape, seed=0):
    b, sq, sk, h, hd = shape[:5]
    rng = np.random.default_rng(seed + sq + sk)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, h, hd), (b, sk, h, hd),
                      (b, sq, h, hd))]                 # q, k, v, dout


def _ref_grads(arrays, dtype, causal, qo):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: ref_flash(
        q, k, v, causal=causal, q_offset=qo, block_q=64, block_k=64,
        interpret=True), jq, jk, jv)
    return [np.asarray(g, np.float32) for g in vjp(jdo)]


def _port(arrays, dtype, causal, qo):
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in arrays)
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo)
    return q, k, v, dout, out, lse


CASES = ([(torch.float32, s) for s in SHAPES]
         + [(torch.bfloat16, s) for s in SHAPES[:3]])


@pytest.mark.parametrize("dtype,shape", CASES, ids=[
    f"{str(d).split('.')[-1]}-{'-'.join(map(str, s))}" for d, s in CASES])
def test_flash_bwd_plain_matches_reference(dtype, shape):
    causal, qo = shape[5:]
    arrays = _mk(shape)
    q, k, v, dout, out, lse = _port(arrays, dtype, causal, qo)
    got = flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                          q_offset=qo)
    want = _ref_grads(arrays, dtype, causal, qo)
    for name, g, w, t in zip("qkv", got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32_TOL)
        else:
            top = float(np.abs(w).max())
            np.testing.assert_allclose(g.float().numpy(), w, rtol=BF16_REL,
                                       atol=BF16_REL * top, err_msg=name)


@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[4], SHAPES[5]],
                         ids=[IDS[2], IDS[4], IDS[5]])
def test_cpu_wrappers_and_autograd_equal_plain(shape):
    """On the CPU the kernel wrappers and FlashAttention.backward run the
    plain version, launching nothing."""
    causal, qo = shape[5:]
    q, k, v, dout, out, lse = _port(_mk(shape, seed=1), torch.float32,
                                    causal, qo)
    want = flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                           q_offset=qo)
    before = dict(_lib.LAUNCHES)
    delta = row_delta(out, dout)
    kw = dict(causal=causal, q_offset=qo)
    got = (flash_bwd_dq(q, k, v, dout, lse, delta, **kw),
           *flash_bwd_dkv(q, k, v, dout, lse, delta, **kw))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(flash_bwd(q, k, v, out, lse, dout, **kw), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, **kw).backward(dout)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert dict(_lib.LAUNCHES) == before


# (b, sq, sk, h, kv, hd, causal, q_offset): grouped k, v at G 2, 4 and 8
GQA_SHAPES = [(2, 40, 72, 4, 2, 64, True, 0), (1, 48, 80, 8, 2, 64, False, 0),
              (1, 40, 72, 16, 2, 64, True, 24), (1, 33, 50, 8, 1, 128, True, 5)]
GQA_IDS = [f"G{s[3] // s[4]}-" + "-".join(map(str, s)) for s in GQA_SHAPES]
GQA_CASES = ([(torch.float32, s) for s in GQA_SHAPES]
             + [(torch.bfloat16, s) for s in GQA_SHAPES[:3]])


def _mk_gqa(shape, seed=0):
    """q, k, v, dout as numpy float32 for a GQA_SHAPES row."""
    b, sq, sk, h, kv, hd = shape[:6]
    rng = np.random.default_rng(seed + 10 * h + kv)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
                      (b, sq, h, hd))]


@pytest.mark.parametrize("dtype,shape", GQA_CASES, ids=[
    f"{str(d).split('.')[-1]}-{i}" for d, s in GQA_CASES
    for i in [GQA_IDS[GQA_SHAPES.index(s)]]])
def test_grouped_flash_bwd_plain_matches_reference(dtype, shape):
    """``flash_bwd_plain`` on k, v [B, Sk, KV, hd]: dq, and dk, dv summed
    over each group of G query heads in float32 and rounded once, against
    ``jax.vjp`` of the reference's ``chunked_attention`` on the same
    grouped heads: float32 at 2e-4, bfloat16 at 3e-2 of each gradient's
    largest magnitude."""
    causal, qo = shape[6:]
    arrays = _mk_gqa(shape)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: ref_chunked(
        q, k, v, causal=causal, q_chunk=16, kv_chunk=32, q_offset=qo),
        jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jdo)]
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in arrays)
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo)
    got = flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                          q_offset=qo)
    for name, g, w, t in zip("qkv", got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32_TOL)
        else:
            top = float(np.abs(w).max())
            np.testing.assert_allclose(g.float().numpy(), w, rtol=BF16_REL,
                                       atol=BF16_REL * top, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GQA_SHAPES, ids=GQA_IDS)
def test_cpu_wrappers_and_autograd_equal_plain_on_grouped_heads(dtype,
                                                                shape):
    """On the CPU the kernel wrappers, ``flash_bwd`` and
    ``FlashAttention.backward`` take grouped k, v as they are and give
    ``flash_bwd_plain``'s bits, launching nothing."""
    causal, qo = shape[6:]
    q, k, v, dout = (torch.from_numpy(a).to(dtype)
                     for a in _mk_gqa(shape, seed=1))
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo)
    want = flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                           q_offset=qo)
    assert want[1].shape == k.shape and want[2].shape == v.shape
    before = dict(_lib.LAUNCHES)
    delta = row_delta(out, dout)
    kw = dict(causal=causal, q_offset=qo)
    got = (flash_bwd_dq(q, k, v, dout, lse, delta, **kw),
           *flash_bwd_dkv(q, k, v, dout, lse, delta, **kw))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(flash_bwd(q, k, v, out, lse, dout, **kw), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, **kw).backward(dout)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert dict(_lib.LAUNCHES) == before


def test_grouped_dk_dv_are_rounded_once():
    """dk and dv of a group are the float32 sums of its heads' gradients,
    rounded to bfloat16 once (as ``jax.grad`` of the reference's
    ``chunked_attention`` sums them inside a float32 einsum), not the sums
    of each head's rounded gradient."""
    shape = GQA_SHAPES[2]
    causal, qo = shape[6:]
    b, sq, sk, h, kv, hd = shape[:6]
    g = h // kv
    q, k, v, dout = (torch.from_numpy(a).bfloat16()
                     for a in _mk_gqa(shape, seed=3))
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo)
    _, dk, dv = flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                q_offset=qo)
    _, dk_h, dv_h = _bwd_plain(q, k.repeat_interleave(g, 2),
                               v.repeat_interleave(g, 2), dout, lse,
                               row_delta(out, dout), causal, qo)
    for got, per_head in zip((dk, dv), (dk_h, dv_h)):
        heads = per_head.view(b, sk, kv, g, hd)           # float32
        torch.testing.assert_close(got, heads.sum(3).bfloat16(), rtol=0,
                                   atol=0)
        assert not torch.equal(
            got, heads.bfloat16().float().sum(3).bfloat16())


def test_backward_refuses_kv_not_dividing_h():
    """k, v with KV heads that do not divide q's H are refused by both
    wrappers, on the CPU as on a card (``_check_bwd``)."""
    q, k, v, dout = (torch.from_numpy(a) for a in _mk_gqa(GQA_SHAPES[1]))
    out, lse = flash_fwd(q, k, v, causal=False)
    delta = row_delta(out, dout)
    three = torch.cat([k, k[:, :, :1]], dim=2)          # 3 kv heads, H = 8
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="GQA"):
            fn(q, three, three, dout, lse, delta)
    with pytest.raises(ValueError, match="GQA"):
        flash_bwd_dq(q, k[:, :, :0], v[:, :, :0], dout, lse, delta)


def test_row_delta_uses_the_rounded_output():
    """delta = Σ_hd do·out over out as the forward rounded it to q's
    dtype, widened to float32 (the TPU backward's D)."""
    q, k, v, dout, out, _ = _port(_mk(SHAPES[0], seed=2), torch.bfloat16,
                                  True, 0)
    want = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    torch.testing.assert_close(row_delta(out, dout), want, rtol=1e-6,
                               atol=1e-6)
    assert row_delta(out, dout).dtype == torch.float32


def test_backward_checks_operands():
    q, k, v, dout, out, lse = _port(_mk(SHAPES[0]), torch.float32, True, 0)
    delta = row_delta(out, dout)
    with pytest.raises(TypeError, match="dout"):
        flash_bwd_dq(q, k, v, dout.bfloat16(), lse, delta)
    with pytest.raises(TypeError, match="dout"):
        flash_bwd_dkv(q, k, v, dout[:, :64], lse, delta)
    with pytest.raises(TypeError, match="lse"):
        flash_bwd_dq(q, k, v, dout, lse.double(), delta)
    with pytest.raises(TypeError, match="delta"):
        flash_bwd_dkv(q, k, v, dout, lse, delta[:, :, :5])
    with pytest.raises(TypeError):
        flash_bwd_dq(q, k.bfloat16(), v, dout, lse, delta)


def test_row_limit_flags_a_fault_in_the_last_key_tile():
    """Why the card checks of kernels 7 and 8 in bfloat16 (chip_smoke.py's
    ``bwd_row_atol``, tests/test_torch_cuda.py's ``_bwd_close``) take
    their atol per row of head-dim values: under the causal mask |dk|,
    |dv| fall from the first keys to the last, so zeroing the last
    128-key tile (a kernel-8 block that skipped its q tiles) stays under
    3e-2 of the tensor's largest magnitude at 2,048 tokens, and only a
    limit of 3e-2 of each row's own largest magnitude (plus 1e-5 of the
    tensor's, for rows that cancel to float32 noise) flags it."""
    rng = np.random.default_rng(0)
    b, s, h, kv, hd = 1, 2048, 2, 1, 64
    q, dout = (torch.from_numpy(rng.standard_normal((b, s, h, hd))
                                .astype(np.float32)).bfloat16()
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, hd))
                             .astype(np.float32)).bfloat16()
            for _ in range(2))
    out, lse = flash_fwd(q, k, v, causal=True)
    _, dk, dv = flash_bwd_plain(q, k, v, out, lse, dout, causal=True)
    for want in (dk.float(), dv.float()):
        got = want.clone()
        got[:, -128:] = 0
        err = (got - want).abs()
        whole = BF16_REL * (want.abs().max() + want.abs())
        rows = (BF16_REL * (want.abs().amax(dim=-1, keepdim=True)
                            + want.abs()) + 1e-5 * want.abs().max())
        assert not (err > whole).any()
        assert (err > rows)[:, -128:].float().mean() > 0.5
