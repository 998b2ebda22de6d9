"""The port's flash attention backward on the CPU against the JAX
package: ``flash_bwd_plain`` (the plain version of kernels 7 and 8)
against ``jax.vjp`` of the reference's Pallas ``flash_attention`` in
interpret mode (block 64) over the reference tests' shape sweep (causal
and full, ragged, q_offset); the CPU paths of the two kernel wrappers and
of the autograd backward against ``flash_bwd_plain``. Inputs and
cotangents are numpy, from a seed.

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
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import (flash_attention, flash_bwd,
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
