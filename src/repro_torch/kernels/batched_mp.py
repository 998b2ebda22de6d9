"""Batched dense message passing: kernel 9 and its plain version.

``out[b] = (adj[b] @ x[b]) @ w`` for ``adj [B, N, N]``, ``x [B, N, F]``,
``w [F, H]`` float32 → ``[B, N, H]`` float32: the aggregation of the GNN's
dense-batch (molecule) forward, once per layer.

  batched_mp — kernel 9, two routes chosen by shape alone (``route``).
               Replaces the reference's ``batched_mp``.
      "mma"    (``csrc/batched_mp_mma.cu``) for N <= 64, F <= 128, H <=
               128, the molecule regime: a persistent grid whose pairs
               of warps each walk graphs through a cp.async ring beside
               w, which stays in shared memory; both products on the
               tensor cores (mma.sync TF32, each operand split in two:
               3xTF32, float32 accuracy). ``mma_plan`` sizes it.
      "tiled"  (``csrc/batched_mp.cu``) for every larger graph: one
               block per (graph, row tile of adj, H tile), its rows of
               adj, an F tile of x, its agg tile and the matching rows of
               w in shared memory, true float32 FMAs.
  batched_mp_plain — ``ref.batched_mp_ref``: two einsums.
  BatchedMP — the autograd Function ``batched_mp`` applies: kernel 9
               forward, and kernel 9 again as its own backward. For
               ``y = (A x) w``: ``g = Aᵀ dy`` is one launch,
               ``batched_mp(adjᵀ, dy, I_H)`` (counted under
               ``LAUNCHES["batched_mp_bwd"]``); ``dx = g wᵀ`` and
               ``dw = Σ_b x_bᵀ g_b`` (one GEMM over the B·N rows) are
               ``torch.matmul``, products the reference also computes
               outside any Pallas kernel. ``adj`` takes no gradient.

A block has at most 227 KB of shared memory (the TPU kernel holds a whole
graph in its 16 MiB of VMEM), so ``tiles`` picks the tiled route's row, F
and H tile widths that fit: the whole adj (RT = N) wherever it fits, and
row tiles of adj beyond that (N 240 and up). Past about N 6,400 the only
tiles that fit take more than the grid's 65,535 blocks per graph (at F =
H = 64 the largest N is 6,448), and from N 29,055 none fit at all: such a
graph raises ``ValueError``. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches one kernel or raises: no route
gives way to the other. On a ``meta`` tensor (a dry run) it checks the
route at the H100's shared memory, allocates the output, records the
call in ``work.TALLY`` and launches nothing. Both routes sum in another
order than the plain version: they agree within float32 rounding, not
bit for bit.
"""
from __future__ import annotations

import torch

from . import _lib, ref, work
from .interval_stab import is_meta, on_cpu

batched_mp_plain = ref.batched_mp_ref
MAX_TILES = 65535        # blocks per graph: the row × H tiles on grid.y
H100_SMEM = 232_448      # shared memory a block may opt in to on an H100
MMA_MAX_N = 64           # the tensor-core route's bounds
MMA_MAX_FH = 128
MMA_MAX_PAIRS = 8        # its pipelines (pairs of warps) a block


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


def _up(v: int, to: int) -> int:
    return -(-v // to) * to


def mma_plan(n: int, f: int, h: int, limit: int = H100_SMEM) -> dict:
    """The tensor-core route's block, as ``csrc/batched_mp_mma.cu`` lays
    it out: w split into float4s [4·KF, H8·HC + 2] once (F padded to
    8·KF: KF 2 up to F 16, 8 up to 64, 16 beyond; H to chunks of 8·HC
    columns: HC 2 up to H 16, else 4), and for each pipeline (a pair of
    warps) a ring of ``stages`` stages, each adj [N16, N8 + 4] and x
    [N8, 8·KF + 8] (row strides that keep fragment loads free of bank
    conflicts). ``pairs``: as many pipelines as one stage each lets fit
    in ``limit`` bytes, at most 8 (4 at KF 16; 0 where not even one
    fits); then two stages where those pipelines' fit. On an H100 more
    pipelines beat a second stage at the bulk call (F = H = 64: 8 of one
    stage against 7 of two), and a second stage helps where both fit (F
    = H = 16)."""
    kf = 2 if f <= 16 else 8 if f <= 64 else 16
    hc = 2 if h <= 16 else 4
    kn = _up(n, 8)
    sa, sx = kn + 4, 8 * kf + 8
    stage = 4 * (_up(n, 16) * sa + kn * sx)
    w_bytes = 16 * 4 * kf * (_up(h, 8 * hc) + 2)
    most = MMA_MAX_PAIRS // 2 if kf > 8 else MMA_MAX_PAIRS
    pairs = max(0, min(most, (limit - w_bytes) // stage))
    stages = 2 if w_bytes + 2 * pairs * stage <= limit else 1
    return dict(pairs=pairs, stages=stages, kf=kf, hc=hc, sa=sa, sx=sx,
                stage_bytes=stage, w_bytes=w_bytes,
                smem=w_bytes + pairs * stages * stage)


def route(n: int, f: int, h: int, limit: int = H100_SMEM) -> str:
    """Kernel 9's route for graphs of N nodes, F features in and H out,
    from the shape alone: "mma" within N <= 64, F, H <= 128 (where
    ``mma_plan`` fits at least one pipeline in ``limit`` bytes), else
    "tiled". Raises ``ValueError`` where the tiled route refuses the
    graph (``tiles``)."""
    if min(n, f, h) < 1:
        raise ValueError(f"batched_mp takes N, F, H >= 1, got N={n}, "
                         f"F={f}, H={h}")
    if (n <= MMA_MAX_N and max(f, h) <= MMA_MAX_FH
            and mma_plan(n, f, h, limit)["pairs"] >= 1):
        return "mma"
    tiles(n, f, h, limit)
    return "tiled"


def batched_mp(adj, x, w):
    """Kernel 9: (adj @ x) @ w, [B, N, H] float32, for adj [B, N, N],
    x [B, N, F] and w [F, H] float32; differentiable in x and w
    (``BatchedMP``). Raises ``ValueError`` if adj requires a gradient."""
    if adj.requires_grad:
        raise ValueError("batched_mp: adj takes no gradient (kernel 9's "
                         "backward gives dx and dw only)")
    return BatchedMP.apply(adj, x, w)


class BatchedMP(torch.autograd.Function):
    """``(adj @ x) @ w`` with kernel 9 forward and backward (the plain
    version on CPU tensors, in both directions)."""

    @staticmethod
    def forward(ctx, adj, x, w):
        ctx.save_for_backward(adj, x, w)
        return _call(adj, x, w, "batched_mp")

    @staticmethod
    def backward(ctx, dy):
        adj, x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            h = dy.shape[-1]
            eye = torch.eye(h, dtype=dy.dtype, device=dy.device)
            g = _call(adj.transpose(1, 2).contiguous(), dy.contiguous(), eye,
                      "batched_mp_bwd")                       # Aᵀ dy
            if ctx.needs_input_grad[1]:
                dx = torch.matmul(g, w.t())
            if ctx.needs_input_grad[2]:
                dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, h)
        return None, dx, dw


def _call(adj, x, w, counter: str):
    """One kernel-9 call (counted under ``counter``) or, on CPU tensors,
    the plain version."""
    if on_cpu(adj):
        return batched_mp_plain(adj, x, w)
    b, n, _ = adj.shape
    f, h = w.shape
    dev = adj.device
    if is_meta(adj):
        route(n, f, h)
        work.TALLY.add(counter, (adj, x, w))
        return torch.empty((b, n, h), dtype=torch.float32, device=dev)
    limit = _lib.max_smem(dev)
    kind = route(n, f, h, limit)
    args = (_lib.check(adj, "adj", (b, n, n), dev, dtype="float32"),
            _lib.check(x, "x", (b, n, f), dev, dtype="float32"),
            _lib.check(w, "w", (f, h), dev, dtype="float32"))
    out = torch.empty((b, n, h), dtype=torch.float32, device=dev)
    if not b:
        return out
    if kind == "mma":
        plan = mma_plan(n, f, h, limit)
        _lib.launch(counter, "reach_batched_mp_mma", dev, *args,
                    out.data_ptr(), b, n, f, h, plan["pairs"],
                    plan["stages"])
    else:
        _lib.launch(counter, "reach_batched_mp", dev, *args,
                    out.data_ptr(), b, n, f, h, *tiles(n, f, h, limit))
    return out
