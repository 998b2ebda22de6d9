"""Sparse phase-2 frontier expansion: the fused-step BFS loop with kernels
3 and 4 and their plain versions.

A chunk of UNKNOWN queries expands in lockstep over the ELL slab + COO
tail layout (``PackedIndex.ell_layout``). Per step, with the same state
evolution as the reference's ``expand_frontier_loop_fused``:

  gather   — ``ell[front]`` pulls the W out-neighbours of every frontier
             entry; when a hub is in the frontier, the COO tail is swept
             edge-parallel, gated by a per-query frontier bitset.
  probe    — kernel 3 (``csrc/frontier.cu``): visited-bitset test,
             answered-query test and validity mask, then the packed key
             or SENTINEL. Replaces the reference's ``_probe_kernel``.
  compact  — prefix-sum compaction of the survivors into cap+1 slots,
             then a fixed-size sorted unique with SENTINEL fill. A raw
             survivor count above cap+1 raises the overflow flag (the
             reference's conservative rule), as does a live key in slot
             ``cap``. With ``distinct_overflow`` (the 12-array layout,
             where the reference runs its XLA loop) the unique runs over
             all survivors instead and only a live key in slot ``cap``
             (more than cap distinct keys) overflows.
  classify — kernel 4: the phase-1 packed verdict on the survivors, the
             s == t early positive, and the next-frontier emit. Replaces
             the reference's ``_classify_emit_kernel``.
  mark     — the visited bits of the survivors, OR'd in by scatter-add.

The reference runs the loop on the device under ``lax.while_loop`` and
picks the tail branch with ``lax.cond``. Here the loop runs on the host:
the stop test and the hub test of the next step come back together in
one device-to-host sync per step (``STEPS`` counts steps and syncs).

Overflow contract: under overflow, positives are sound; the caller
retries the rest with a larger cap.
"""
from __future__ import annotations

import torch

from . import _lib, ref
from .frontier import SENTINEL, _bit, check_key_space, or_bits
from .interval_stab import on_cpu

STEPS = _lib.Counters(steps=0, syncs=0)


# ---------------------------------------------------------------- kernel 3
def probe_plain(cq, cv, ok, visited, pos, vbits: int):
    okb = ok != 0
    cq = torch.where(okb, cq, 0)
    cv = torch.where(okb, cv, 0)
    vw = visited[cq.long(), (cv >> 5).long()]
    # int32 arithmetic shift + &1 still extracts bit (cv & 31) exactly,
    # the sign bit included
    seen = ((vw >> (cv & 31)) & 1) != 0
    alive = okb & ~seen & (pos[cq.long()] == 0)
    return torch.where(alive, (cq << vbits) | cv, SENTINEL).to(torch.int32)


def probe(cq, cv, ok, visited, pos, vbits: int):
    """Kernel 3: packed key [C] int32 of each raw candidate, or SENTINEL.

    cq, cv, ok: [C] int32 (query, node, valid); visited: [Q, ceil(n/32)]
    int32 bitset; pos: [Q] int32, 1 where the query is answered."""
    if on_cpu(cq):
        return probe_plain(cq, cv, ok, visited, pos, vbits)
    c, dev = cq.shape[0], cq.device
    args = (_lib.check(cq, "cq", (c,), dev),
            _lib.check(cv, "cv", (c,), dev),
            _lib.check(ok, "ok", (c,), dev),
            _lib.check(visited, "visited", None, dev),
            _lib.check(pos, "pos", (visited.shape[0],), dev))
    keys = torch.empty(c, dtype=torch.int32, device=dev)
    if c:
        _lib.launch("probe", "reach_probe", dev, *args, keys.data_ptr(), c,
                    visited.shape[1], vbits)
    return keys


# ---------------------------------------------------------------- kernel 4
def emit_plain(verdict, keys):
    """Frontier emit: dead (SENTINEL) slots read NEG; UNKNOWN survivors
    keep their key for the next frontier, everything else SENTINEL."""
    valid = keys != SENTINEL
    out = torch.where(valid, verdict, ref.NEG).to(torch.int32)
    front = torch.where(valid & (verdict == ref.UNKNOWN), keys, SENTINEL)
    return out, front.to(torch.int32)


def classify_emit_plain(meta_s, meta_t, slab_s, keys, eq):
    v = ref.interval_stab_classify_packed_ref(meta_s, meta_t, slab_s)
    return emit_plain(torch.where(eq != 0, ref.POS, v), keys)


def classify_emit(meta_s, meta_t, slab_s, keys, eq):
    """Kernel 4: (verdict [C], next-frontier keys [C]) of the survivors
    from their gathered rows: meta_s/meta_t [C, 4], slab_s [C, 2K], keys
    and eq (1 where the candidate is its query's target) [C] int32."""
    if on_cpu(keys):
        return classify_emit_plain(meta_s, meta_t, slab_s, keys, eq)
    c, k2, dev = keys.shape[0], slab_s.shape[1], keys.device
    args = (_lib.check(meta_s, "meta_s", (c, 4), dev, align=16),
            _lib.check(meta_t, "meta_t", (c, 4), dev, align=16),
            _lib.check(slab_s, "slab_s", (c, k2), dev),
            _lib.check(keys, "keys", (c,), dev),
            _lib.check(eq, "eq", (c,), dev))
    verdict = torch.empty(c, dtype=torch.int32, device=dev)
    front = torch.empty(c, dtype=torch.int32, device=dev)
    if c:
        _lib.launch("classify_emit", "reach_classify_emit", dev, *args,
                    verdict.data_ptr(), front.data_ptr(), c, k2 // 2)
    return verdict, front


# -------------------------------------------------------------- the loop
def unique_fixed(x):
    """Sorted unique values of ``x``, SENTINEL-filled to ``x``'s length —
    ``jnp.unique(x, size=x.size, fill_value=SENTINEL)``. Duplicates all
    scatter the same value into the slot of their first occurrence, so
    the result is deterministic and needs no host sync."""
    s = torch.sort(x).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1
    return torch.full_like(s, SENTINEL).scatter_(0, slot, s)


def expand_frontier_loop_fused(ell, tail_src, tail_dst, is_hub, cs, ct,
                               pad, *, n_nodes: int, max_steps: int,
                               cap: int, gather_rows, fetch_rows,
                               classify=classify_emit,
                               distinct_overflow: bool = False):
    """The fused-step BFS loop over one chunk of Q queries.

    ell [n, W], tail_src/tail_dst [m_t], cs/ct [Q] int32; is_hub [n] and
    pad [Q] bool. ``gather_rows(table, ids)`` pulls rows by global node
    id; ``fetch_rows(cands, tgts)`` returns the operands that
    ``classify(*operands, keys, eq)`` turns into (verdict, front) — the
    gathered meta/slab rows for kernel 4 on one device. Both hooks stay
    pluggable for a sharded placement. ``distinct_overflow`` selects the
    overflow rule of the reference's XLA loop (``kernels/frontier.py``):
    overflow iff more than ``cap`` distinct survivor keys. Returns
    (pos [Q] bool, overflow).
    """
    n, w = n_nodes, ell.shape[1]
    q = cs.shape[0]
    m_t = int(tail_src.shape[0])
    vbits = check_key_space(n, q, cap)
    vmask = (1 << vbits) - 1
    n_words = (n + 31) // 32
    i32 = dict(dtype=torch.int32, device=cs.device)

    qi = torch.arange(q, **i32)
    front = torch.full((cap,), SENTINEL, **i32)
    front[:q] = torch.where(pad, SENTINEL, (qi << vbits) | cs)
    visited = or_bits(torch.zeros((q, n_words), **i32), qi, cs >> 5,
                      torch.where(pad, 0, _bit(cs)).to(torch.int32))
    pos = torch.zeros(q, **i32)
    overflow = torch.zeros((), dtype=torch.bool, device=cs.device)

    def flags(front):
        # one device-to-host sync: overflow, frontier live, hub in frontier
        fvalid = front != SENTINEL
        fv = torch.where(fvalid, front & vmask, 0)
        hub = ((is_hub[fv.long()] & fvalid).any() if m_t
               else torch.zeros_like(overflow))
        STEPS["syncs"] += 1
        return torch.stack([overflow, fvalid.any(), hub]).tolist()

    ovf, live, hub = flags(front)
    step = 0
    while step < max_steps and not ovf and live:
        fvalid = front != SENTINEL
        fq = torch.where(fvalid, front >> vbits, 0)
        fv = torch.where(fvalid, front & vmask, 0)
        nbr = gather_rows(ell, fv)                          # [cap, W]
        cq = fq[:, None].expand(cap, w).reshape(-1)
        cv = nbr.reshape(-1)
        ok = (fvalid[:, None] & (nbr >= 0)).reshape(-1)
        if hub:
            # heavy tail: edge-parallel sweep gated by a frontier bitset
            fbits = or_bits(torch.zeros((q, n_words), **i32), fq, fv >> 5,
                            torch.where(fvalid, _bit(fv), 0).to(torch.int32))
            act = (fbits[:, (tail_src >> 5).long()]
                   >> (tail_src & 31)[None, :]) & 1
            cq = torch.cat([cq, qi[:, None].expand(q, m_t).reshape(-1)])
            cv = torch.cat([cv, tail_dst[None, :].expand(q, m_t).reshape(-1)])
            ok = torch.cat([ok, (act == 1).reshape(-1)])
        keys = probe(cq.contiguous(), cv.contiguous(), ok.to(torch.int32),
                     visited, pos, vbits)
        if distinct_overflow:
            # the XLA loop's rule: a sorted unique of every survivor
            uniq = unique_fixed(torch.cat(
                [keys, torch.full((cap + 1,), SENTINEL, **i32)]))[:cap + 1]
            overflow = overflow | (uniq[cap] != SENTINEL)
        else:
            # O(C) compaction into cap+1 slots, then a small sorted unique
            emit = keys != SENTINEL
            raw = emit.sum()
            slot = torch.cumsum(emit, 0) - 1
            slot = torch.where(emit & (slot <= cap), slot, cap + 1)
            compacted = torch.full((cap + 2,), SENTINEL, **i32).scatter_(
                0, slot, keys)[:cap + 1]
            uniq = unique_fixed(compacted)
            overflow = overflow | (raw > cap + 1) | (uniq[cap] != SENTINEL)
        new = uniq[:cap]
        nvalid = new != SENTINEL
        nq = torch.where(nvalid, new >> vbits, 0)
        nv = torch.where(nvalid, new & vmask, 0)

        nt = ct[nq.long()]                        # target node ids
        verdict, fkey = classify(*fetch_rows(nv, nt), new,
                                 (nv == nt).to(torch.int32))
        pos.scatter_reduce_(0, nq.long(),
                            (nvalid & (verdict == ref.POS)).to(torch.int32),
                            reduce="amax")
        or_bits(visited, nq, nv >> 5,
                torch.where(nvalid, _bit(nv), 0).to(torch.int32))
        front = torch.where(pos[nq.long()] == 0, fkey, SENTINEL).to(
            torch.int32)
        step += 1
        STEPS["steps"] += 1
        ovf, live, hub = flags(front)
    return pos != 0, bool(ovf)
