"""Batched dense message passing: kernel 9 and its plain version.

``out[b] = (adj[b] @ x[b]) @ w`` for ``adj [B, N, N]``, ``x [B, N, F]``,
``w [F, H]`` float32 → ``[B, N, H]`` float32: the aggregation of the GNN's
dense-batch (molecule) forward, once per layer.

  batched_mp — kernel 9 (``csrc/batched_mp.cu``): one block per (graph,
               row tile of adj, H tile), its rows of adj, an F tile of x,
               its agg tile and the matching rows of w in shared memory,
               true float32 FMAs. Replaces the reference's ``batched_mp``.
  batched_mp_plain — ``ref.batched_mp_ref``: two einsums.

A block has at most 227 KB of shared memory (the TPU kernel holds a whole
graph in its 16 MiB of VMEM), so ``tiles`` picks the row, F and H tile
widths that fit: the whole adj (RT = N) wherever it fits, as for the
molecule shape, and row tiles of adj beyond that (N 240 and up). Past
about N 6,400 the only tiles that fit take more than the grid's 65,535
blocks per graph (at F = H = 64 the largest N is 6,448), and from N
29,055 none fit at all: such a graph raises ``ValueError``. On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. The kernel sums in another order than the plain
version: they agree within float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from . import _lib, ref
from .interval_stab import on_cpu

batched_mp_plain = ref.batched_mp_ref
MAX_TILES = 65535        # blocks per graph: the row × H tiles on grid.y


def smem_bytes(n: int, rt: int, ft: int, ht: int) -> int:
    """Shared memory of one block: its RT rows of adj, the x and agg
    tiles, the w tile and the output accumulator."""
    return 4 * (rt * n + n * ft + rt * ft + ft * ht + rt * ht)


def tiles(n: int, f: int, h: int, limit: int):
    """(RT, FT, HT): row, F and H tile widths whose block fits in
    ``limit`` bytes of shared memory. With the whole adj (RT = N), F is
    cut first (down to 8), since a narrower H tile makes every H tile
    recompute the aggregation, then H, then F below 8. Where no such
    block fits, F is cut to 8 and the rows of adj are halved until the
    row tile fits (a row tile recomputes nothing; it reads x again), then
    H and F go down to 1. Raises ``ValueError`` where no block fits, or
    where the tiles of one graph exceed the grid's ``MAX_TILES``."""
    ft, ht = f, h
    while smem_bytes(n, n, ft, ht) > limit:
        if ft > 8 or (ft > 1 and ht <= 8):
            ft = -(-ft // 2)
        elif ht > 1:
            ht = -(-ht // 2)
        else:
            break
    else:
        return n, ft, ht
    rt, ft, ht = n, f, h
    while smem_bytes(n, rt, ft, ht) > limit:
        if ft > 8:
            ft = -(-ft // 2)
        elif rt > 1:
            rt = -(-rt // 2)
        elif ht > 1:
            ht = -(-ht // 2)
        elif ft > 1:
            ft = -(-ft // 2)
        else:
            raise ValueError(
                f"batched_mp: a graph of N={n} nodes needs "
                f"{smem_bytes(n, 1, 1, 1)} B of shared memory even with "
                f"row, F and H tiles of 1; a block may use {limit} B")
    blocks = -(-n // rt) * -(-h // ht)
    if blocks > MAX_TILES:
        raise ValueError(
            f"batched_mp: a graph of N={n} nodes fits a block's {limit} B "
            f"of shared memory only with (RT, FT, HT) = {(rt, ft, ht)}, "
            f"which takes {blocks} blocks per graph; the grid's y "
            f"dimension holds {MAX_TILES}")
    return rt, ft, ht


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
    rt, ft, ht = tiles(n, f, h, _lib.max_smem(dev))
    args = (_lib.check(adj, "adj", (b, n, n), dev, dtype="float32"),
            _lib.check(x, "x", (b, n, f), dev, dtype="float32"),
            _lib.check(w, "w", (f, h), dev, dtype="float32"))
    out = torch.empty((b, n, h), dtype=torch.float32, device=dev)
    if b:
        _lib.launch("batched_mp", "reach_batched_mp", dev, *args,
                    out.data_ptr(), b, n, f, h, rt, ft, ht)
    return out
