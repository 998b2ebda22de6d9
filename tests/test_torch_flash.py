"""The port's flash attention (kernel 6's plain version, the CPU path of
``flash_attention`` and its autograd wrapper) and its ``chunked_attention``
on the CPU against the JAX package: the reference's Pallas
``flash_attention`` and ``_flash_fwd`` in interpret mode over the
reference tests' shape sweep, and the reference's scan-based
``chunked_attention`` with GQA. Inputs are numpy, from a seed.

Tolerances are the reference tests' own: 2e-5 in float32 (the same
softmax summed in another order), 3e-2 in bfloat16 (the Pallas kernel
rounds the softmax numerators to bfloat16, the plain version does not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_fwd
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models.attention import chunked_attention as ref_chunked
from repro_torch.kernels import _lib, ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_fwd)
from repro_torch.models.attention import chunked_attention, decode_attention

pytestmark = pytest.mark.arch

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)

SHAPES = [
    # (b, sq, sk, h, hd, causal, q_offset): the reference test's sweep
    (1, 128, 128, 2, 64, True, 0),
    (2, 256, 256, 1, 128, True, 0),
    (1, 130, 190, 2, 64, True, 0),       # ragged
    (1, 64, 512, 1, 64, False, 0),       # cross-attention style
    (2, 64, 256, 2, 64, True, 192),      # continuation: q at offset
    (1, 96, 96, 3, 128, False, 0),
]


def _mk(b, sq, sk, h, hd, seed=0, kv=None):
    rng = np.random.default_rng(seed)
    kv = kv or h
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32))


def _both(arrays, dtype):
    """The same inputs for the reference (jnp) and the port (torch)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


CASES = ([(torch.float32, shape, F32_TOL) for shape in SHAPES]
         + [(torch.bfloat16, shape, BF16_TOL) for shape in SHAPES[:3]])


@pytest.mark.parametrize("dtype,shape,tol", CASES, ids=[
    f"{str(d).split('.')[-1]}-{'-'.join(map(str, s))}" for d, s, _ in CASES])
def test_flash_matches_reference_kernel(dtype, shape, tol):
    b, sq, sk, h, hd, causal, qo = shape
    (jq, jk, jv), (q, k, v) = _both(_mk(b, sq, sk, h, hd), dtype)
    want = ref_flash(jq, jk, jv, causal=causal, q_offset=qo, block_q=64,
                     block_k=64, interpret=True)
    got = flash_attention(q, k, v, causal=causal, q_offset=qo)
    assert got.shape == (b, sq, h, hd) and got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,sq,sk,h,hd,causal,qo",
                         [SHAPES[2], SHAPES[4], SHAPES[5]])
def test_lse_matches_reference_kernel(b, sq, sk, h, hd, causal, qo):
    (jq, jk, jv), (q, k, v) = _both(_mk(b, sq, sk, h, hd, seed=1),
                                    torch.float32)
    _, lse_p, _ = _flash_fwd(jq, jk, jv, causal, qo, 64, 64, True)
    want = np.asarray(lse_p).reshape(b, h, -1)[:, :, :sq]     # unpad
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, **F32_TOL)
    np.testing.assert_array_equal(
        out.numpy(), flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=qo)[0].numpy())


@pytest.mark.parametrize("h,kv,causal,qo", [(4, 2, True, 0), (6, 2, True, 0),
                                            (6, 3, False, 0), (4, 1, True, 40)])
def test_chunked_attention_gqa_matches_reference(h, kv, causal, qo):
    """GQA (G = H / KV of 2 or 3): query head h reads kv head h // G, the
    reference's [KV, G] grouping; a plain repeat would pair the wrong
    heads."""
    arrays = _mk(2, 48, 80, h, 64, seed=h + kv, kv=kv)
    (jq, jk, jv), (q, k, v) = _both(arrays, torch.float32)
    want = ref_chunked(jq, jk, jv, causal=causal, q_chunk=16, kv_chunk=32,
                       q_offset=qo)
    got = chunked_attention(q, k, v, causal=causal, q_offset=qo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# (H, KV, causal, q_offset): G = H / KV of 2, 4 and 8
GQA_CASES = [(4, 2, True, 0), (4, 2, False, 0), (8, 2, True, 40),
             (8, 2, False, 16), (16, 2, True, 0), (8, 1, False, 40)]
GQA_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,kv,causal,qo", GQA_CASES)
def test_flash_fwd_gqa_matches_reference(h, kv, causal, qo):
    """Grouped k, v [B, Sk, KV, hd] read in place: kernel 6's plain
    version (out and lse) and ``chunked_attention`` against the
    reference's scan-based ``chunked_attention`` on the grouped heads and
    its Pallas kernel (interpret mode) on heads expanded by jnp.repeat."""
    g = h // kv
    arrays = _mk(2, 48, 80, h, 64, seed=10 * h + kv + qo, kv=kv)
    (jq, jk, jv), (q, k, v) = _both(arrays, torch.float32)
    want = np.asarray(ref_chunked(jq, jk, jv, causal=causal, q_chunk=16,
                                  kv_chunk=32, q_offset=qo))
    jk_x, jv_x = jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2)
    want_k = ref_flash(jq, jk_x, jv_x, causal=causal, q_offset=qo,
                       block_q=64, block_k=64, interpret=True)
    _, want_lse, _ = _flash_fwd(jq, jk_x, jv_x, causal, qo, 64, 64, True)
    want_lse = np.asarray(want_lse).reshape(2, h, -1)[:, :, :48]
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo)
    got = chunked_attention(q, k, v, causal=causal, q_offset=qo)
    for a in (out, got):
        assert a.shape == (2, 48, h, 64)
        np.testing.assert_allclose(a.numpy(), want, **GQA_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(want_k), **GQA_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **GQA_TOL)


@pytest.mark.parametrize("h,kv,causal,qo", GQA_CASES[::2] + GQA_CASES[5:])
def test_gqa_backward_matches_reference_grad(h, kv, causal, qo):
    """The CPU autograd backward through the grouped path
    (``flash_bwd_plain`` on the grouped k, v, dk and dv summed over each
    group in float32) against jax.grad of the reference's
    ``chunked_attention`` on grouped heads."""
    arrays = _mk(1, 40, 72, h, 64, seed=20 * h + kv + qo, kv=kv)
    (jq, jk, jv), (q, k, v) = _both(arrays, torch.float32)
    dout = np.random.default_rng(h + qo).standard_normal(q.shape).astype(
        np.float32)

    def loss(a, b_, c):
        o = ref_chunked(a, b_, c, causal=causal, q_chunk=8, kv_chunk=24,
                        q_offset=qo)
        return jnp.sum(o * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    chunked_attention(*leaves, causal=causal, q_offset=qo).backward(
        torch.from_numpy(dout))
    for got, w in zip(leaves, want):
        assert got.grad.shape == w.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   **GQA_TOL)


def test_short_causal_rows_and_finite():
    """S = 70 under the causal mask: row 0 sees only k[0], and the ragged
    tail of every tile is masked."""
    (jq, jk, jv), (q, k, v) = _both(_mk(1, 70, 70, 1, 64), torch.float32)
    want = ref_flash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                     interpret=True)
    got = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               **F32_TOL)


def test_backward_on_cpu_matches_reference():
    """On the CPU the wrapper's backward differentiates the plain version;
    the reference differentiates its Pallas kernels (interpret mode)."""
    arrays = _mk(1, 64, 64, 2, 64, seed=4)
    (jq, jk, jv), (q, k, v) = _both(arrays, torch.float32)
    dout = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)

    def loss(a, b_, c):
        o = ref_flash(a, b_, c, causal=True, block_q=64, block_k=64,
                      interpret=True)
        return jnp.sum(o * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    out.backward(torch.from_numpy(dout))
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_cpu_path_launches_nothing_and_checks_operands():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 8, 8, 2, 32))
    before = dict(_lib.LAUNCHES)
    np.testing.assert_array_equal(
        ops.attention(q, k, v).numpy(), flash_attention_plain(q, k, v)[0]
        .numpy())            # hd 32 runs the plain version on the CPU
    assert dict(_lib.LAUNCHES) == before
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    three = torch.cat([k, k[:, :, :1]], dim=2)       # 3 kv heads, H = 2
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, three, three)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :0], v[:, :0])


def test_decode_attention_matches_reference():
    from repro.models.attention import decode_attention as ref_decode
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 6, 64)).astype(np.float32)
    kc = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    want = ref_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                      jnp.int32(17))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                         torch.from_numpy(vc), 17,
                         k_scale=torch.ones(2, 40, 2))


def test_decode_attention_bf16_matches_reference():
    """bfloat16 cache: the reference takes the scores in float32
    (``preferred_element_type``); so must the port. q is scaled so that
    the scores reach ~±100, where a bfloat16 rounding of them (a step of
    0.5) would move the softmax far past the tolerance."""
    from repro.models.attention import decode_attention as ref_decode
    rng = np.random.default_rng(7)
    q = 8 * rng.standard_normal((2, 1, 8, 64)).astype(np.float32)
    kc = rng.standard_normal((2, 300, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((2, 300, 2, 64)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), torch.bfloat16)
    want = np.asarray(ref_decode(jq, jk, jv, jnp.int32(250)), np.float32)
    got = decode_attention(tq, tk, tv, 250)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())
