"""Merge + top-gap cover of begin-sorted interval rows: kernel 5 and its
plain version.

Per row of m begin-sorted ``(b, e, x)`` slots (INVALID / -1 / 0 pads at
the tail): union-merge the intervals with exact-coverage tracking, then
keep the k-1 largest gaps between consecutive merged runs (ties keep the
leftmost gap) and cover each group of runs between kept gaps with one
interval, exact only if the group is one exact run. Output ``nb, ne, nx
[B, w_out]`` int32 (groups past w_out are dropped; empty slots INVALID /
-1 / 0) and ``cnt [B] = min(runs, k)``. This is the per-wave compute of
the device index build (``core.build``).

  merge_cover — kernel 5 (``csrc/merge_cover.cu``), one thread per row,
                128 rows a block, their output slabs staged in shared
                memory and written with 16-byte stores, and narrow rows'
                begins staged with 16-byte loads (``plan``). Replaces the
                reference's ``merge_cover_sorted_rows``.
  merge_cover_plain — the reference's own math written out over rows:
                the ``_merge_sorted_row`` recurrence as a loop over the
                slots, vectorised across rows, then ``_topgap_cover_row``
                with stable-sort gap ranks and segment reductions.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _lib
from .interval_stab import on_cpu

INVALID = 2**31 - 1
MAX_K = 33                     # the kernel keeps at most 32 gaps per row
ROWS_PER_BLOCK = 128           # the kernel's rows (threads) a block
MAX_STAGED_M = 32              # begins staged in shared memory up to this m
MAX_STAGED_W_OUT = 64          # outputs staged up to this w_out


def _merge_rows_plain(cb, ce, cx):
    """The ``_merge_sorted_row`` recurrence on every row at once: the
    merged runs packed to the front of (ob, oe [B, m] int64, ox [B, m]
    bool) and the run count [B]. Slots past the last column that holds a
    valid begin in any row change nothing and are not visited."""
    b_all, m = cb.shape[0], cb.shape[1]
    dev = cb.device
    i64 = dict(dtype=torch.int64, device=dev)
    b, e, x = cb.long(), ce.long(), cx != 0
    valid_any = (cb < INVALID).any(0).nonzero()
    cols = int(valid_any.max()) + 1 if valid_any.numel() else 0
    cur_b = torch.zeros(b_all, **i64)
    cur_e = torch.full((b_all,), -1, **i64)
    ece = torch.full((b_all,), -2, **i64)
    holed = torch.ones(b_all, dtype=torch.bool, device=dev)
    cnt = torch.full((b_all,), -1, **i64)
    # column m parks the writes of rows that flush nothing this slot
    ob = torch.full((b_all, m + 1), INVALID, **i64)
    oe = torch.full((b_all, m + 1), -1, **i64)
    ox = torch.zeros((b_all, m + 1), dtype=torch.bool, device=dev)

    def flush(when, exact):
        slot = torch.where(when, cnt, m)[:, None]
        ob.scatter_(1, slot, cur_b[:, None])
        oe.scatter_(1, slot, cur_e[:, None])
        ox.scatter_(1, slot, exact[:, None])

    for i in range(cols):
        bi, ei, xi = b[:, i], e[:, i], x[:, i]
        valid = bi < INVALID
        opened = cnt >= 0
        cur_exact = ~holed & (ece >= cur_e)
        do_merge = opened & valid & (
            (bi <= cur_e) | ((bi == cur_e + 1) & (cur_exact == xi)))
        do_open = valid & ~do_merge
        flush(do_open & opened, cur_exact)
        ece_m = torch.where(xi & (bi <= ece + 1), torch.maximum(ece, ei), ece)
        holed_m = holed | (xi & (bi > ece + 1))
        cnt = torch.where(do_open, cnt + 1, cnt)
        cur_b = torch.where(do_open, bi, cur_b)
        cur_e = torch.where(do_open, ei,
                            torch.where(do_merge, torch.maximum(cur_e, ei),
                                        cur_e))
        ece = torch.where(do_open, torch.where(xi, ei, bi - 1),
                          torch.where(do_merge, ece_m, ece))
        holed = torch.where(do_open, False,
                            torch.where(do_merge, holed_m, holed))
    flush(cnt >= 0, ~holed & (ece >= cur_e))
    return ob[:, :m], oe[:, :m], ox[:, :m], cnt + 1


def merge_cover_plain(cb, ce, cx, k: int, w_out: int):
    """The plain version of kernel 5: (nb, ne, nx [B, w_out], cnt [B])
    int32 of begin-sorted rows cb, ce, cx [B, m] int32."""
    b_all, m = cb.shape
    ob, oe, ox, runs = _merge_rows_plain(cb, ce, cx)
    idx = torch.arange(m, device=cb.device)
    valid = idx[None, :] < runs[:, None]
    gap_valid = idx[None, :] + 1 < runs[:, None]
    nxt = torch.cat([ob[:, 1:], ob[:, -1:]], dim=1)
    gaps = torch.where(gap_valid, nxt - oe - 1, -1)
    order = torch.sort(-gaps, dim=1, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        1, order, idx[None, :].expand(b_all, m).contiguous())
    keep = (ranks < k - 1) & gap_valid
    grp = torch.cumsum(keep.long(), dim=1) - keep.long()
    # invalid slots and groups past w_out land in the dropped segment
    grp = torch.where(valid, grp, w_out).clamp(max=w_out)
    i64 = dict(dtype=torch.int64, device=cb.device)
    nb = torch.full((b_all, w_out + 1), INVALID, **i64).scatter_reduce_(
        1, grp, torch.where(valid, ob, INVALID), "amin")
    ne = torch.full((b_all, w_out + 1), -1, **i64).scatter_reduce_(
        1, grp, torch.where(valid, oe, -1), "amax")
    sz = torch.zeros((b_all, w_out + 1), **i64).scatter_add_(
        1, grp, valid.long())
    anyx = torch.zeros((b_all, w_out + 1), **i64).scatter_reduce_(
        1, grp, (valid & ox).long(), "amax")
    nb, ne, sz, anyx = nb[:, :w_out], ne[:, :w_out], sz[:, :w_out], \
        anyx[:, :w_out]
    nx = (sz == 1) & (anyx > 0)
    nb = torch.where(sz > 0, nb, INVALID)
    ne = torch.where(sz > 0, ne, -1)
    return (nb.to(torch.int32), ne.to(torch.int32), nx.to(torch.int32),
            torch.clamp(runs, max=k).to(torch.int32))


def plan(m: int, w_out: int) -> dict:
    """Kernel 5's staging for rows of m slots and w_out outputs, from the
    shape alone: where m <= 32 (the build's largest call has m 9; wider
    rows walk device memory), a block's 128 begin rows ``[128, m | 1]``
    in shared memory, and where w_out <= 64 its three output slabs
    ``3 x [128, w_out | 1]``. Odd row strides keep the per-row walk free
    of bank conflicts. ``smem``: the block's bytes."""
    stage_cb, stage_out = m <= MAX_STAGED_M, w_out <= MAX_STAGED_W_OUT
    words = ((m | 1) if stage_cb else 0) + (3 * (w_out | 1)
                                            if stage_out else 0)
    return dict(rows=ROWS_PER_BLOCK, stage_cb=stage_cb, stage_out=stage_out,
                smem=4 * ROWS_PER_BLOCK * words)


def merge_cover(cb, ce, cx, k: int, w_out: int):
    """Kernel 5: (nb, ne, nx [B, w_out], cnt [B]) int32 of the begin-sorted
    rows cb, ce, cx [B, m] int32, covered to at most k intervals."""
    if on_cpu(cb):
        return merge_cover_plain(cb, ce, cx, k, w_out)
    if not (1 <= k <= MAX_K and w_out >= 1):
        raise ValueError(f"merge_cover takes 1 <= k <= {MAX_K} and "
                         f"w_out >= 1, got k={k}, w_out={w_out}")
    rows, m = cb.shape
    dev = cb.device
    args = (_lib.check(cb, "cb", (rows, m), dev),
            _lib.check(ce, "ce", (rows, m), dev),
            _lib.check(cx, "cx", (rows, m), dev))
    nb = torch.empty((rows, w_out), dtype=torch.int32, device=dev)
    ne = torch.empty_like(nb)
    nx = torch.empty_like(nb)
    cnt = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        p = plan(m, w_out)
        _lib.launch("merge_cover", "reach_merge_cover", dev, *args,
                    nb.data_ptr(), ne.data_ptr(), nx.data_ptr(),
                    cnt.data_ptr(), rows, m, k, w_out, int(p["stage_cb"]),
                    int(p["stage_out"]))
    return nb, ne, nx, cnt
