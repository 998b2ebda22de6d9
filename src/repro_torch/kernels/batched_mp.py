"""Batched dense message passing: kernel 9 and its plain version.

``out[b] = (adj[b] @ x[b]) @ w`` for ``adj [B, N, N]``, ``x [B, N, F]``,
``w [F, H]`` float32 → ``[B, N, H]`` float32: the aggregation of the GNN's
dense-batch (molecule) forward, once per layer.

  batched_mp — kernel 9 (``csrc/batched_mp.cu``): one block per graph,
               adj, an F tile of x, its agg tile and the matching rows of
               w in shared memory, true float32 FMAs. Replaces the
               reference's ``batched_mp``.
  batched_mp_plain — ``ref.batched_mp_ref``: two einsums.

A block has at most 227 KB of shared memory (the TPU kernel holds a whole
graph in VMEM), so ``tiles`` picks the F and H tile widths that fit; a
graph too large for any tiling raises ``ValueError``. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel
or raises. The kernel sums in another order than the plain version: they
agree within float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from . import _lib, ref
from .interval_stab import on_cpu

batched_mp_plain = ref.batched_mp_ref


def smem_bytes(n: int, ft: int, ht: int) -> int:
    """Shared memory of one block: adj, the x and agg tiles, the w tile
    and the output accumulator."""
    return 4 * (n * n + 2 * n * ft + ft * ht + n * ht)


def tiles(n: int, f: int, h: int, limit: int):
    """(FT, HT): the widest F tile, then H tile, whose block fits in
    ``limit`` bytes of shared memory. F is cut first (down to 8), since a
    narrower H tile makes every H tile recompute the aggregation."""
    ft, ht = f, h
    while smem_bytes(n, ft, ht) > limit:
        if ft > 8 or (ft > 1 and ht <= 8):
            ft = -(-ft // 2)
        elif ht > 1:
            ht = -(-ht // 2)
        else:
            raise ValueError(
                f"batched_mp: a graph of N={n} nodes needs "
                f"{smem_bytes(n, 1, 1)} B of shared memory even with F and "
                f"H tiles of 1; a block may use {limit} B")
    return ft, ht


def batched_mp(adj, x, w):
    """Kernel 9: (adj @ x) @ w, [B, N, H] float32, for adj [B, N, N],
    x [B, N, F] and w [F, H] float32."""
    if on_cpu(adj):
        return batched_mp_plain(adj, x, w)
    b, n, _ = adj.shape
    f, h = w.shape
    dev = adj.device
    if min(n, f, h) < 1:
        raise ValueError(f"batched_mp takes N, F, H >= 1, got adj "
                         f"{tuple(adj.shape)}, w {tuple(w.shape)}")
    ft, ht = tiles(n, f, h, _lib.max_smem(dev))
    args = (_lib.check(adj, "adj", (b, n, n), dev, dtype="float32"),
            _lib.check(x, "x", (b, n, f), dev, dtype="float32"),
            _lib.check(w, "w", (f, h), dev, dtype="float32"))
    out = torch.empty((b, n, h), dtype=torch.float32, device=dev)
    if b:
        _lib.launch("batched_mp", "reach_batched_mp", dev, *args,
                    out.data_ptr(), b, n, f, h, ft, ht)
    return out
