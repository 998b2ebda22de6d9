"""Phase-1 interval-stab classification: kernels 1 and 2 and their plain
versions.

Per query (s, t) of condensed ids: test π(t) against the source's interval
slab, with the topological-order filter (Eq. 11), the level filter (§5.2)
and the seed rules (§5.1), plus the s == t early positive. Verdicts are
int32 in {0 NEG, 1 POS, 2 UNKNOWN}.

  stab_packed — kernel 1 (``csrc/interval_stab.cu``), the gather-fused
                layout: ``meta [n, 4]`` and ``slab [n, 2K]``. Replaces the
                reference's ``interval_stab_classify_packed``.
  stab_packed_owned — kernel 1's owned-rows entry for the sharded
                placement: t's meta rows by query position (the owned-
                rows exchange), the source's rows in this rank's shard at
                cs - base, 0 where the rank does not own the source. What
                the reference's kernel computes on gathered rows (its
                ``_prefetched`` form).
  stab_naive  — kernel 2, the 12-array layout with W-word seeds and
                unsaturated levels (used when the fused layout does not
                fit). Replaces the reference's ``interval_stab_classify``.

Unlike the reference, which gathers the rows in XLA and streams them into
the kernel, both kernels take the tables and the (cs, ct) ids and do the
row gathers themselves; ids must lie in [0, n). Each query takes a group
of lanes that load its rows together (``launch_shape``). On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises; on a ``meta`` tensor (a dry run) kernel 1's entries allocate
their verdicts, record the call in ``work.TALLY`` and launch nothing.
"""
from __future__ import annotations

import functools

import torch

from . import _lib, ref, work

MAX_GRID = 2**31 - 1     # blocks on the grid's x dimension


def vector_width(k: int) -> int:
    """int32 a lane loads at once from a table row of K slots: 4 (16 bytes)
    where K % 4 == 0, else 2 where K is even, else 1. Every row and piece
    is then aligned to its load: kernel 1's slab rows of 2K and their ends
    at offset K, kernel 2's rows of K."""
    return 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1


@functools.lru_cache(maxsize=1024)
def launch_shape(q: int, k: int, w: int = 0, sms: int = 132) -> tuple:
    """(threads per block, lanes per query, blocks) of kernels 1 and 2 for
    Q queries over rows of K slots and W seed words of s and of t (kernel
    2; kernel 1's one seed word lies in its meta row: W = 0) on a card of
    ``sms`` streaming multiprocessors (132 on an H100 SXM). Cached: a
    path's calls come in a few bucket sizes.

    A query's group has a lane for each ``vector_width(k)``-wide piece of
    its slots and for each seed word, rounded up to a power of two and at
    most 32 (lanes then loop). Blocks start at 256 threads, halved down to
    32 while the grid would have fewer than two blocks an SM, so that the
    serving path's call (16,384 queries, 2 lanes each at K 8) spreads over
    every SM. Raises ``ValueError`` where the kernels cannot take the call.
    """
    if q < 0 or k < 0 or w < 0:
        raise ValueError(f"stab launch: need Q, K, W >= 0, got Q={q}, "
                         f"K={k}, W={w}")
    need = max(k // vector_width(k), w, 1)
    lanes = 1
    while lanes < min(need, 32):
        lanes <<= 1
    threads = 256
    while threads > 32 and -(-q * lanes // threads) < 2 * sms:
        threads //= 2
    blocks = max(1, -(-q * lanes // threads))
    if blocks > MAX_GRID:
        raise ValueError(f"stab launch: {q} queries of {lanes} lanes take "
                         f"{blocks} blocks of {threads}; the grid holds "
                         f"{MAX_GRID}")
    return threads, lanes, blocks


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_cpu(t) -> bool:
    """True for a CPU tensor, False for a CUDA or a ``meta`` one (the
    latter takes ``is_meta``'s branch); other devices raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type in ("cuda", "meta"):
        return False
    raise ValueError(f"unsupported device {t.device}")


def is_meta(t) -> bool:
    """True for a ``meta`` tensor (a dry run): a wrapper then allocates
    the outputs its launch would, records the call in ``work.TALLY`` and
    launches nothing."""
    return t.device.type == "meta"


def stab_packed_plain(meta, slab, cs, ct):
    s, t = cs.long(), ct.long()
    v = ref.interval_stab_classify_packed_ref(meta[s], meta[t], slab[s])
    return torch.where(cs == ct, ref.POS, v).to(torch.int32)


def stab_packed(meta, slab, cs, ct):
    """Kernel 1: verdict [Q] int32 of (cs, ct) on the fused layout."""
    if on_cpu(cs):
        return stab_packed_plain(meta, slab, cs, ct)
    n, q, k2 = meta.shape[0], cs.shape[0], slab.shape[1]
    if k2 % 2:
        raise ValueError(f"slab: {k2} columns, expected 2K")
    if is_meta(cs):
        work.TALLY.add("stab_packed", (meta, slab, cs, ct))
        return torch.empty(q, dtype=torch.int32, device=cs.device)
    k, dev = k2 // 2, cs.device
    vec, shape = vector_width(k), launch_shape(q, k, 0, sm_count(dev.index))
    args = (_lib.check(meta, "meta", (n, 4), dev, align=16),
            _lib.check(slab, "slab", (n, k2), dev, align=4 * vec),
            _lib.check(cs, "cs", (q,), dev),
            _lib.check(ct, "ct", (q,), dev))
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        _lib.launch("stab_packed", "reach_stab_packed", dev, *args,
                    out.data_ptr(), q, k, vec, shape[1], shape[0], shape[2])
    return out


def stab_packed_owned_plain(meta_t, meta, slab, cs, ct, base: int):
    rel = cs.long() - base
    own = (rel >= 0) & (rel < meta.shape[0])
    r = rel.clamp(0, meta.shape[0] - 1)
    v = ref.interval_stab_classify_packed_ref(meta[r], meta_t, slab[r])
    v = torch.where(cs == ct, ref.POS, v)
    return torch.where(own, v, 0).to(torch.int32)


def stab_packed_owned(meta_t, meta, slab, cs, ct, base: int):
    """Kernel 1's owned-rows entry: verdict [Q] int32 of (cs, ct) from
    ``meta_t`` [Q, 4] (t's meta rows by query position) and this rank's
    ``meta`` [n_loc, 4] / ``slab`` [n_loc, 2K], rows of node ids
    ``base`` .. ``base + n_loc``; 0 where the rank does not own cs."""
    if on_cpu(cs):
        return stab_packed_owned_plain(meta_t, meta, slab, cs, ct, base)
    n, q, k2 = meta.shape[0], cs.shape[0], slab.shape[1]
    if k2 % 2:
        raise ValueError(f"slab: {k2} columns, expected 2K")
    if is_meta(cs):
        work.TALLY.add("stab_packed_owned",
                       (meta_t, meta, slab, cs, ct, base))
        return torch.empty(q, dtype=torch.int32, device=cs.device)
    k, dev = k2 // 2, cs.device
    vec, shape = vector_width(k), launch_shape(q, k, 0, sm_count(dev.index))
    args = (_lib.check(meta_t, "meta_t", (q, 4), dev, align=16),
            _lib.check(meta, "meta", (n, 4), dev, align=16),
            _lib.check(slab, "slab", (n, k2), dev, align=4 * vec),
            _lib.check(cs, "cs", (q,), dev),
            _lib.check(ct, "ct", (q,), dev))
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        _lib.launch("stab_packed_owned", "reach_stab_packed_owned", dev,
                    *args, out.data_ptr(), q, k, vec, shape[1], shape[0],
                    shape[2], int(base), n)
    return out


def stab_naive_plain(pi, tau, blevel, begins, ends, exact, s_plus, s_minus,
                     cs, ct):
    s, t = cs.long(), ct.long()
    v = ref.interval_stab_classify_ref(
        pi[t], tau[s], tau[t], blevel[s], blevel[t],
        begins[s], ends[s], exact[s],
        s_plus[s], s_minus[s], s_plus[t], s_minus[t])
    return torch.where(cs == ct, ref.POS, v).to(torch.int32)


def stab_naive(pi, tau, blevel, begins, ends, exact, s_plus, s_minus,
               cs, ct):
    """Kernel 2: verdict [Q] int32 of (cs, ct) on the 12-array layout.
    ``s_plus``/``s_minus`` are [n, W] int32 views of the seed words, with
    W = 0 when the index has no seeds."""
    if on_cpu(cs):
        return stab_naive_plain(pi, tau, blevel, begins, ends, exact,
                                s_plus, s_minus, cs, ct)
    n, q = pi.shape[0], cs.shape[0]
    k, w = begins.shape[1], s_plus.shape[1]
    dev = cs.device
    vec = vector_width(k)
    shape = launch_shape(q, k, w, sm_count(dev.index))
    args = (_lib.check(pi, "pi", (n,), dev),
            _lib.check(tau, "tau", (n,), dev),
            _lib.check(blevel, "blevel", (n,), dev),
            _lib.check(begins, "begins", (n, k), dev, align=4 * vec),
            _lib.check(ends, "ends", (n, k), dev, align=4 * vec),
            _lib.check(exact, "exact", (n, k), dev, align=4 * vec),
            _lib.check(s_plus, "s_plus", (n, w), dev),
            _lib.check(s_minus, "s_minus", (n, w), dev),
            _lib.check(cs, "cs", (q,), dev),
            _lib.check(ct, "ct", (q,), dev))
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        _lib.launch("stab_naive", "reach_stab_naive", dev, *args,
                    out.data_ptr(), q, k, w, vec, shape[1], shape[0],
                    shape[2])
    return out
