"""The work of one kernel call: the bytes it must move and the operations
it must do, and the tally of the calls that a dry run makes on ``meta``
tensors.

``work(name, args)`` -> (bytes, ops) of one call of kernel ``name`` (a
``_lib.LAUNCHES`` name) on the wrapper's arguments: int32 operations for
the reachability kernels, flops (2 per multiply-add) for kernels 6 to 10.
Each input element the result depends on is read once — a table row that
several queries gather counts once — and each output is written once;
rows the result does not depend on (those of cs == ct pairs) are not
counted. Where the work depends on the data, it is counted on this call's
data. On ``meta`` tensors there is no data: every query counts as live
and every id as distinct, up to the table's rows, the most the call could
need. The sparse phase 2's kernels 3 and 4 are counted on a step's state,
by the card's smoke run.

``TALLY`` holds what the wrappers' ``meta`` branch records in place of a
launch (``TALLY.add``): per kernel name, its calls and their flops and
bytes. It is a counter of its own: a ``meta`` call launches nothing and
never counts in ``_lib.LAUNCHES``.
"""
from __future__ import annotations

import numpy as np
import torch

INVALID = 2**31 - 1          # kernel 5's empty slot


def _distinct(*ids) -> int:
    return int(torch.unique(torch.cat(ids)).numel())


def _meta(t) -> bool:
    return t.device.type == "meta"


def _seen(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """Unmasked (q, k) pairs of one head: each query row sees the keys up
    to its position when causal, all of them otherwise."""
    if not causal:
        return sq * sk
    return int(np.minimum(q_offset + np.arange(sq, dtype=np.int64) + 1,
                          sk).sum())


def _stab_packed(meta, slab, cs, ct):
    k, n, q = slab.shape[1] // 2, meta.shape[0], cs.shape[0]
    if _meta(cs):
        live, both, src = q, min(2 * q, n), min(q, n)
    else:
        keep = cs != ct
        s, t = cs[keep], ct[keep]
        live, both, src = int(keep.sum()), _distinct(s, t), _distinct(s)
    return q * 12 + both * 16 + src * 8 * k, live * (6 * k + 25) + q


def _stab_packed_owned(meta_t, meta, slab, cs, ct, base):
    # t's meta row by query position (16 B a live query), the owned
    # sources' meta and slab rows, the ids and the verdicts
    k, q = slab.shape[1] // 2, cs.shape[0]
    if _meta(cs):
        live, src = q, min(q, meta.shape[0])
    else:
        rel = cs.long() - base
        keep = (rel >= 0) & (rel < meta.shape[0]) & (cs != ct)
        live, src = int(keep.sum()), _distinct(cs[keep])
    return q * 12 + live * 16 + src * (16 + 8 * k), live * (6 * k + 25) + q


def _stab_naive(pi, tau, lvl, b, e, x, sp, sm, cs, ct):
    k, w, n, q = b.shape[1], sp.shape[1], pi.shape[0], cs.shape[0]
    if _meta(cs):
        live, both, src, tgt = q, min(2 * q, n), min(q, n), min(q, n)
    else:
        keep = cs != ct
        s, t = cs[keep], ct[keep]
        live, both = int(keep.sum()), _distinct(s, t)
        src, tgt = _distinct(s), _distinct(t)
    nbytes = q * 12 + both * (8 + 8 * w) + src * 12 * k + tgt * 4
    return nbytes, live * (6 * k + 8 * w + 10) + q


def _retrieval_score(cands, ints):
    (c, d), i = cands.shape, ints.shape[0]
    return 4 * (c * d + i * d + c), 2 * c * i * d


def _batched_mp(adj, x, w):
    (b, n, f), h = x.shape, w.shape[1]
    return (4 * (b * n * n + b * n * f + f * h + b * n * h),
            2 * b * n * n * f + 2 * b * n * f * h)


def _flash_fwd(q, k, v, causal, q_offset):
    # 4·hd flops for each unmasked (q, k) pair: q·k and p·v; k and v read
    # once at their KV heads (grouped, read in place)
    b, sq, h, hd = q.shape
    nbytes = ((2 * q.numel() + k.numel() + v.numel()) * q.element_size()
              + 4 * b * h * sq)
    return nbytes, 4 * hd * b * h * _seen(sq, k.shape[1], causal, q_offset)


def _flash_bwd(name):
    # 6·hd flops per unmasked pair for dq (q·k, do·v, dS·k), 8·hd for dk,
    # dv (q·k, do·v, Pᵀ·do, dSᵀ·q); q, k, v, do, lse and delta read once,
    # dq or dk and dv written once
    def one(q, k, v, dout, lse, delta, causal, q_offset):
        b, sq, h, hd = q.shape
        outs = q.numel() if name == "flash_bwd_dq" else 2 * k.numel()
        nbytes = ((2 * q.numel() + 2 * k.numel() + outs) * q.element_size()
                  + 8 * b * h * sq)
        per = 6 if name == "flash_bwd_dq" else 8
        return nbytes, per * hd * b * h * _seen(sq, k.shape[1], causal,
                                                q_offset)
    return one


def _merge_cover(cb, ce, cx, k, w_out):
    rows, m = cb.shape
    if _meta(cb):
        valid, short = rows * m, 0
    else:
        n_valid = (cb != INVALID).sum(1)
        valid, short = int(n_valid.sum()), int((n_valid < m).sum())
    # 12 B per valid slot, the first INVALID begin of a row that has one,
    # the outputs; ~10 int32 ops per slot for the recurrence
    return valid * 12 + short * 4 + rows * (12 * w_out + 4), valid * 10


_WORK = {"stab_packed": _stab_packed,
         "stab_packed_owned": _stab_packed_owned,
         "stab_naive": _stab_naive,
         "retrieval_score": _retrieval_score,
         "batched_mp": _batched_mp, "batched_mp_bwd": _batched_mp,
         "flash_fwd": _flash_fwd,
         "flash_bwd_dq": _flash_bwd("flash_bwd_dq"),
         "flash_bwd_dkv": _flash_bwd("flash_bwd_dkv"),
         "merge_cover": _merge_cover}


def work(name: str, args) -> tuple:
    """(bytes, ops) of one call of kernel ``name`` on ``args``: the
    wrapper's tensors and sizes in its order (flash calls: q, k, v, then
    dout, lse, delta for the backward, then causal and q_offset)."""
    return tuple(int(x) for x in _WORK[name](*args))


class Tally(dict):
    """Per kernel name: {"launches", "flops", "bytes"} of its ``meta``
    calls."""

    def add(self, name: str, args) -> None:
        """Record one ``meta`` call of kernel ``name`` on ``args``."""
        nbytes, ops = work(name, args)
        row = self.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
        row["launches"] += 1
        row["flops"] += ops
        row["bytes"] += nbytes


TALLY = Tally()
