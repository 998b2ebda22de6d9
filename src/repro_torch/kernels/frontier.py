"""Key packing and bitset helpers of the sparse phase-2 frontier engine.

A (query, node) candidate packs into a non-negative int32 key: the node in
the low ``vbits = ceil(log2 n)`` bits, the query above, and SENTINEL =
INT32_MAX marks a dead slot. This bounds a batch at ``2**(31 - vbits) - 1``
queries per expansion; the engine chunks accordingly. The BFS loop itself
is in ``kernels.frontier_fused``.
"""
from __future__ import annotations

import torch

SENTINEL = 2**31 - 1
_INT32_MIN = -(2**31)


def key_bits(n: int) -> int:
    """Bits needed for a node id; queries use the remaining 31 - vbits."""
    return max(1, int(n - 1).bit_length())


def max_batch(n: int) -> int:
    # minus one: at a full 2**(31-vbits) batch the key of (last query,
    # node n-1) could equal SENTINEL when n is a power of two
    return (1 << (31 - key_bits(n))) - 1


def check_key_space(n: int, q: int, cap: int) -> int:
    """Key-space guard; returns ``vbits``. A packed key (q << vbits) | v
    must stay strictly below SENTINEL: vbits <= 30 leaves at least one
    query bit, and q < 2**(31 - vbits) (strict, as ``max_batch``) keeps
    the all-ones key (q-1, n-1) from aliasing SENTINEL when n is a power
    of two."""
    vbits = key_bits(n)
    if vbits > 30:
        raise ValueError(
            f"n_nodes={n} needs {vbits} node bits; packed (query, node) "
            "keys support at most 30 (n < 2**30) — chunk the graph or use "
            "the dense phase-2 path")
    if not (q <= cap and q < (1 << (31 - vbits))):
        raise ValueError(
            f"batch of {q} queries exceeds max_batch({n}) = {max_batch(n)} "
            f"or cap={cap}")
    return vbits


def _bit(v):
    """The int32 word bit of node ``v`` within its 32-node word. Bit 31 is
    built explicitly as INT32_MIN (the uint32 ``1 << 31`` of the
    reference); the rest are plain shifts."""
    sh = v & 31
    low = torch.bitwise_left_shift(torch.ones_like(v), sh.clamp(max=30))
    return torch.where(sh == 31, _INT32_MIN, low).to(torch.int32)


def or_bits(words, rows, cols, bits):
    """``words[rows, cols] |= bits`` for DISJOINT bits (deduplicated keys),
    as an int32 scatter-add: adding disjoint powers of two is an OR, and
    two's-complement wrap gives the same word as the reference's uint32
    add, bit 31 included. ``words`` is a contiguous [R, C] int32 tensor."""
    flat = rows.long() * words.shape[1] + cols.long()
    words.view(-1).index_put_((flat,), bits, accumulate=True)
    return words
