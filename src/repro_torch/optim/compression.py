"""Gradient compression: int8 quantization with error feedback.

``compress_with_feedback(grads, err)`` quantizes every gradient leaf to
int8 with a per-tensor scale, carries the quantization error into the
next step (error feedback — keeps SGD/Adam convergence), and returns the
dequantized gradients. ``compressed_psum(x, group)`` is the compressed
sum over a process group: the scale agreed by an all-reduce MAX of the
ranks' largest magnitudes, then an all-reduce of the int32 quantized
values, then one dequantize, so every rank dequantizes alike.

The values are the reference's bit for bit: rounding half to even, as
``jnp.round`` does, and true divisions on tensors (on a card a division
by a Python number can run as a product with its reciprocal, which
rounds differently). As in the reference, nothing on the train path
calls these: the train step's gradient sums are uncompressed.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce_


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as a true division of tensors."""
    if not isinstance(d, torch.Tensor):
        d = torch.full((), d, dtype=x.dtype, device=x.device)
    return x / d


def _quantize(x: torch.Tensor, amax: torch.Tensor, dtype):
    scale = _div(amax, 127.0)
    return torch.clamp(torch.round(_div(x, scale)), -127, 127).to(dtype), \
        scale


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    return _quantize(x, x.abs().max() + 1e-12, torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _zip_map(fn, a, b):
    """``fn`` over the leaves of ``a`` and the matching leaves of ``b``
    (dicts by key, lists in order); ``fn`` returns a pair, and so does
    this: the tree of first members and the tree of second members."""
    if isinstance(a, dict):
        parts = {k: _zip_map(fn, a[k], b[k]) for k in a}
        return ({k: p[0] for k, p in parts.items()},
                {k: p[1] for k, p in parts.items()})
    if isinstance(a, (list, tuple)):
        parts = [_zip_map(fn, x, y) for x, y in zip(a, b)]
        return [p[0] for p in parts], [p[1] for p in parts]
    return fn(a, b)


def compress_with_feedback(grads, err_state):
    """Quantize every gradient leaf, carrying quantization error.

    Returns (dequantized_grads, new_err_state). ``err_state`` is a tree
    matching ``grads`` (float32): ``init_error_state`` starts it."""
    def one(g, e):
        g32 = g.float() + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), g32 - deq
    return _zip_map(one, grads, err_state)


def init_error_state(grads_like):
    def zeros(g, _):
        z = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        return z, None
    return _zip_map(zeros, grads_like, grads_like)[0]


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` through int8-range values:
    amax all-reduced by MAX (+1e-12), the scale amax / 127, round(x /
    scale) clipped to ±127 summed as int32 (as the reference sums them:
    as many bytes as a float32 sum, no overflow), times the scale. A
    group of None (one rank) sums over that rank alone."""
    amax = all_reduce_(x.abs().max().reshape(1), group, "compressed_max",
                       op=dist.ReduceOp.MAX)[0] + 1e-12
    q, scale = _quantize(x, amax, torch.int32)
    return all_reduce_(q, group, "compressed_sum").float() * scale
