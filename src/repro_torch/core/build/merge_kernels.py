"""Row-granular merge/cover of the device index build.

One function, `merge_cover_rows`, is the whole per-wave compute: gather the
source rows of every group, sort each group's intervals by begin, then
union-merge them with exact-coverage tracking and top-gap cover the result
back to the slab width (kernel 5, ``kernels.merge_cover``). Both pipeline
stages (the single-shot wave step and every tree-reduction round, see
``tree_merge.py``) are instances of it; they differ only in which table
the group indices point at and in the working width ``m``.

The merge mirrors ``intervals._sweep`` exactly, so a single-shot merge is
bit-identical to the host builder. The tables live on one device; the
wrapper of kernel 5 picks the kernel or its plain version by that device.
"""
from __future__ import annotations

import torch

from ...kernels import merge_cover as mc

INVALID = 2**31 - 1


def slab_bytes(n_rows: int, m: int) -> int:
    """Working-set bytes of one `merge_cover_rows` call: three int32 buffers
    of [n_rows, m] (begins/ends/exact through the sort and the merge)."""
    return 3 * 4 * int(n_rows) * int(m)


def gather_sorted(begins, ends, exact, group_idx, extra_b, extra_e,
                  m: int):
    """The prologue of `merge_cover_rows`: the begin-sorted slots
    ``(cb, ce, cx [B, max(m, D*W + 1)])`` int32 of every group — its
    extra interval first, then its D source rows, padded with INVALID /
    -1 / 0 to the working width m, then a stable sort by begin."""
    b_rows, d = group_idx.shape
    width = begins.shape[1]
    gi = group_idx.long()
    cb = begins[gi].reshape(b_rows, d * width)
    ce = ends[gi].reshape(b_rows, d * width)
    cx = exact[gi].reshape(b_rows, d * width)
    cb = torch.cat([extra_b[:, None], cb], dim=1)
    ce = torch.cat([extra_e[:, None], ce], dim=1)
    cx = torch.cat([(extra_b[:, None] < INVALID).to(cx.dtype), cx], dim=1)
    if cb.shape[1] < m:
        def pad(a, fill):
            return torch.cat([a, a.new_full((b_rows, m - a.shape[1]), fill)],
                             dim=1)
        cb, ce, cx = pad(cb, INVALID), pad(ce, -1), pad(cx, 0)
    order = torch.sort(cb, dim=1, stable=True).indices
    return (torch.take_along_dim(cb, order, 1).contiguous(),
            torch.take_along_dim(ce, order, 1).contiguous(),
            torch.take_along_dim(cx, order, 1).to(torch.int32).contiguous())


def merge_cover_rows(begins, ends, exact, group_idx, extra_b, extra_e,
                     k: int, w_out: int, m: int):
    """One batched merge+cover pass over row groups.

    ``begins/ends/exact [T, W]`` int32: the source table (the last row is
    an empty dummy row that pad slots point at). ``group_idx [B, D]``: per
    group, the D source rows to union. ``extra_b/extra_e [B]`` int32: one
    extra interval per group, concatenated FIRST — the node's tree
    interval in the wave step and in round 1 of a tree reduction,
    INVALID/-1 (absent) elsewhere — so the stable begin sort visits
    equal-begin intervals in the order of the host ``merge_many([tree] +
    children)``. The gather, concatenation and sort (`gather_sorted`)
    stay PyTorch, as they stay outside the kernel in the reference.

    Returns per-group slabs ``(nb, ne, nx [B, w_out], cnt [B])`` int32,
    covered to ≤ k intervals; ``nx`` is 0/1.
    """
    return mc.merge_cover(*gather_sorted(begins, ends, exact, group_idx,
                                         extra_b, extra_e, m), k, w_out)
