"""Chunked tree-reduction merge — hub fan-in without hub-sized buffers.

A node of out-degree d needs a merge over d·W + 1 interval slots; one hub
would dictate the working width of its whole wave. Fan-in above the
working-width cap is reduced as a tree instead:

    round 1:  children rows, chunks of ``chunk`` → merge+cover(≤ W) each
    round r:  chunks of ``chunk`` partial rows   → merge+cover(≤ W) each
    ...until one row per node remains.

Every round is one `merge_cover_rows` call at the constant width
``m = chunk·W + 1``, so the slab is bounded by (#groups)·m instead of
B·(d_max·W), and ⌈log_chunk d⌉ rounds replace one O(d·W) row walk.

Each intermediate cover is a sound over-approximation (the union only
grows into gap fill-ins marked approximate; exactness is kept only where
provably exact), so the final label covers the same reachable set:
answers are unchanged, only the UNKNOWN residue phase 2 resolves may
differ. The tree interval joins the node's FIRST chunk in round 1,
matching the host merge's concat order within that chunk.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .merge_kernels import INVALID, merge_cover_rows, slab_bytes


@dataclass
class MergeStats:
    """Accounting shared by both pipeline stages (see pipeline.py).

    ``host_fallbacks`` is structurally zero: the staged pipeline has no
    host escape path. The counter is part of the persisted contract
    (``BuildStats``, artifact manifests): any code that reintroduces a
    host merge path must increment it.
    """
    hub_nodes: int = 0
    merge_rounds: int = 0
    host_fallbacks: int = 0
    peak_slab_bytes: int = 0
    kernel_calls: int = 0

    def record(self, n_rows: int, m: int) -> None:
        self.kernel_calls += 1
        self.peak_slab_bytes = max(self.peak_slab_bytes,
                                   slab_bytes(n_rows, m))


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def plan_chunks(counts: np.ndarray, chunk: int):
    """Chunk schedule for one reduction round.

    ``counts[i]``: how many source rows node i currently holds. Returns
    (n_groups per node, group start offsets) — node i owns groups
    ``[starts[i], starts[i] + n_groups[i])`` of the round.
    """
    n_groups = -(-counts // chunk)          # ceil div
    starts = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(n_groups, out=starts[1:])
    return n_groups, starts


def ragged(lens: np.ndarray):
    """(owner, position) of every element of rows of lengths ``lens``."""
    lens = np.asarray(lens, dtype=np.int64)
    owner = np.repeat(np.arange(lens.size), lens)
    pos = np.arange(owner.size) - np.repeat(np.cumsum(lens) - lens, lens)
    return owner, pos


def _chunked_groups(lens, src, starts, g_pad: int, chunk: int, pad_row):
    """[g_pad, chunk] group table: element j of node i (source row
    ``src``, in node order) goes to group ``starts[i] + j // chunk``,
    column ``j % chunk``; empty slots point at ``pad_row``."""
    owner, pos = ragged(lens)
    group_idx = np.full((g_pad, chunk), pad_row, dtype=np.int64)
    group_idx[starts[owner] + pos // chunk, pos % chunk] = src
    return group_idx


def reduce_wave(begins, ends, exact, hubs: np.ndarray,
                indptr: np.ndarray, indices: np.ndarray,
                tree_b: np.ndarray, tree_e: np.ndarray,
                w_out: int, chunk: int, stats: MergeStats):
    """Tree-reduce every hub node of one wave; all hubs advance in lockstep.

    ``begins/ends/exact [n+1, W]`` int32: the global label table on the
    build's device (row n = dummy). ``hubs``: node ids whose fan-in
    exceeds the single-shot cap. ``tree_b/tree_e``: per-hub tree intervals
    (joined in round 1, chunk 0). Returns (nb, ne, nx, ncnt) on the
    device, of shape [len(hubs), w_out] (ncnt [len(hubs)]).
    """
    dev = begins.device
    h = hubs.size
    n_dummy = begins.shape[0] - 1
    m = chunk * w_out + 1

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    # ---- round 1: children rows out of the global table ------------------
    deg = (indptr[hubs + 1] - indptr[hubs]).astype(np.int64)
    n_groups, starts = plan_chunks(deg, chunk)
    g_pad = _pow2(int(starts[-1]))
    owner, pos = ragged(deg)
    group_idx = _chunked_groups(deg, indices[indptr[hubs][owner] + pos],
                                starts, g_pad, chunk, n_dummy)
    eb = np.full(g_pad, INVALID, dtype=np.int32)
    ee = np.full(g_pad, -1, dtype=np.int32)
    eb[starts[:h]] = tree_b
    ee[starts[:h]] = tree_e

    stats.hub_nodes += h
    stats.merge_rounds += 1
    stats.record(g_pad, m)
    sb, se, sx, _ = merge_cover_rows(
        begins, ends, exact, torch.from_numpy(group_idx).to(dev), i32(eb),
        i32(ee), k=w_out, w_out=w_out, m=m)

    # ---- rounds 2..R: chunks of partial rows out of the scratch table ----
    counts = n_groups
    while int(counts.max(initial=1)) > 1:
        n_groups, starts = plan_chunks(counts, chunk)
        g_pad = _pow2(int(starts[-1]))
        scratch_rows = sb.shape[0]
        prev_starts = np.cumsum(counts) - counts
        owner, pos = ragged(counts)
        group_idx = _chunked_groups(counts, prev_starts[owner] + pos,
                                    starts, g_pad, chunk, scratch_rows)
        # append the dummy row the pad slots point at
        tb = torch.cat([sb, sb.new_full((1, w_out), INVALID)])
        te = torch.cat([se, se.new_full((1, w_out), -1)])
        tx = torch.cat([sx, sx.new_zeros((1, w_out))])
        no_extra_b = torch.full((g_pad,), INVALID, dtype=torch.int32,
                                device=dev)
        no_extra_e = torch.full((g_pad,), -1, dtype=torch.int32, device=dev)
        stats.merge_rounds += 1
        stats.record(g_pad, m)
        sb, se, sx, _ = merge_cover_rows(
            tb, te, tx, torch.from_numpy(group_idx).to(dev), no_extra_b,
            no_extra_e, k=w_out, w_out=w_out, m=m)
        counts = n_groups

    # one partial per hub: rows 0..h-1 of the final scratch (starts[i] == i)
    final_cnt = torch.clamp((sb[:h] < INVALID).sum(1), max=w_out).to(
        torch.int32)
    return sb[:h], se[:h], sx[:h], final_cnt
