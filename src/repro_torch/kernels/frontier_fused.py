"""Sparse phase-2 frontier expansion: the BFS loop with kernels 3 and 4
and their plain versions.

A chunk of UNKNOWN queries expands in lockstep over the ELL slab + COO
tail layout (``PackedIndex.ell_layout``), with the state evolution of the
reference's ``expand_frontier_loop_fused``. One step is two kernels
(``csrc/frontier.cu``):

  kernel 3, expand_probe — the candidates of the front: ELL slot j of
      front entry i at i·W + j, then, when a hub is in the front, tail
      edge e of query qi at n_front·W + qi·m_t + e, live where the
      frontier bitset ``fbits`` holds the edge's source for qi. The
      visited, answered and validity tests (``probe_plain``), and the
      survivors compacted in that order into cap + 1 slots, with their
      raw count. Replaces the reference's ``_probe_kernel`` and the
      gathers and compaction around it.
  kernel 3's exchanged-rows entry, expand_probe_rows — the same step with
      the front's ELL rows read from an [n_front, W] buffer in front
      order: the sharded placement (``core.distributed``), where a rank
      holds only its shard of the slab and the rows come from the owned-
      rows exchange (``gather_rows``).
  kernel 4, dedup_classify_emit — the sorted unique of the slots
      (SENTINEL-filled), the overflow rule (raw > cap + 1, or a live key
      in slot cap), the phase-1 packed verdict with the s == t positive,
      the answered flags and visited bits of the live keys, and the next
      front: the UNKNOWN keys of unanswered queries, densely in sorted
      order, with their hub bits. Replaces ``_classify_emit_kernel`` and
      the rest of the step. Under a live overlay (union-graph serving,
      ``reach.dynamic``) it reads ``can_reach_tail`` in place and keeps a
      NEG survivor that can reach a delta tail UNKNOWN, the rule of the
      reference's ``expand_frontier_overlay_fused``; the delta slab rides
      the COO tail, so the graph path serves the overlay as it is.

The loop's state (``StepState``) is a control-word buffer followed by
``pos``, the front, the slots, the visited and frontier bitsets and a log
of the keys marked visited (up to ``LOG_MAX`` beyond the sources; the
clean-up of a call that marked more zeroes the whole bitset). On a card with the fused layout and cap ≤
``SORT_MAX_CAP`` a call is one CUDA graph: set-up, a while node over the
two kernels whose condition kernel 4 sets, and a clean-up that zeroes the
words the call set; the host reads the control words and ``pos`` back
once. Larger caps (the unique is then ``torch.sort``'s, and kernel 4 two
launches, mark and emit) and the 12-array layout (kernel 2 classifies;
overflow by the distinct-count rule, ``distinct_overflow``) step from the
host, reading the control words once a step. On the CPU the same stepped
loop runs the plain versions, through the ``gather_rows``/``fetch_rows``/
``classify`` hooks. ``STEPS`` counts steps (the device's own count),
device-to-host syncs, the launches of kernels 3 and 4 and those of set-up
and clean-up (``helpers``); a graph's launches are the kernels' own
counts, which each keeps in a control word (``L_*``).

Overflow contract: under overflow, positives are sound; the caller
retries the rest with a larger cap.
"""
from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from . import _lib, ref
from .frontier import SENTINEL, _bit, check_key_space, or_bits
from .interval_stab import on_cpu

STEPS = _lib.Counters(steps=0, syncs=0, launches=0, helpers=0)

# control words (csrc/frontier.cu ``Ctl``), then pos [q] in one buffer
CTL_WORDS = 16
RUN, N_FRONT, HUB, OVF, STEP, RAW, TILE, EPOCH, LOG_N, M_NEW = range(10)
# launch counters: each kernel adds one on entry (the plain versions leave
# them alone); kernel 4's two-launch form adds two a step
L_SETUP, L_PROBE, L_CLASSIFY, L_CLEANUP = range(10, 14)
LAUNCH_WORDS = slice(L_SETUP, L_CLEANUP + 1)
# kernel 4 sorts cap + 1 keys in one block's shared memory up to this cap
SORT_MAX_CAP = 16384
PROBE_TILE = 1024           # kernel 3's candidates a tile
MAX_CANDIDATES = 1 << 30    # kernel 3's look-back words hold 30-bit counts
TAIL_BLOCK = 1 << 26        # the plain tail sweep's candidates a block
# keys the log holds beyond a call's sources; a call that marks more has
# its whole visited bitset zeroed by the clean-up instead (the union-graph
# loop runs up to n steps, so cap x max_steps bounds nothing there)
LOG_MAX = 1 << 22
# the int64 argument vector of csrc/frontier.cu's entry points, in order
ARG_FIELDS = ("ctl", "front", "slots", "status", "visited", "fbits", "log",
              "ell", "tail_src", "tail_dst", "is_hub", "meta", "slab", "cs",
              "ct", "pad", "uniq", "verdict_in", "verdict", "can_reach_tail",
              "n_words",
              "slot_cap", "log_cap", "max_tiles", "q", "w", "m_t", "k",
              "cap", "vbits", "max_steps", "rows")


# ------------------------------------------------------- element pieces
def probe_plain(cq, cv, ok, visited, pos, vbits: int):
    """Packed key [C] int32 of each raw candidate (cq, cv, ok: [C] int32;
    visited [Q, ceil(n/32)] int32 bitset; pos [Q] int32, 1 where the query
    is answered), or SENTINEL where it is invalid, seen or answered."""
    okb = ok != 0
    cq = torch.where(okb, cq, 0)
    cv = torch.where(okb, cv, 0)
    vw = visited[cq.long(), (cv >> 5).long()]
    # int32 arithmetic shift + &1 still extracts bit (cv & 31) exactly,
    # the sign bit included
    seen = ((vw >> (cv & 31)) & 1) != 0
    alive = okb & ~seen & (pos[cq.long()] == 0)
    return torch.where(alive, (cq << vbits) | cv, SENTINEL).to(torch.int32)


def emit_plain(verdict, keys):
    """Frontier emit: dead (SENTINEL) slots read NEG; UNKNOWN survivors
    keep their key for the next frontier, everything else SENTINEL."""
    valid = keys != SENTINEL
    out = torch.where(valid, verdict, ref.NEG).to(torch.int32)
    front = torch.where(valid & (verdict == ref.UNKNOWN), keys, SENTINEL)
    return out, front.to(torch.int32)


def classify_emit_plain(meta_s, meta_t, slab_s, keys, eq):
    """(verdict [C], next-frontier keys [C]) of survivors from their
    gathered rows: meta_s/meta_t [C, 4], slab_s [C, 2K], keys and eq (1
    where the candidate is its query's target) [C] int32."""
    v = ref.interval_stab_classify_packed_ref(meta_s, meta_t, slab_s)
    return emit_plain(torch.where(eq != 0, ref.POS, v), keys)


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


def _take(table, ids):
    return table[ids.long()]


def plain_hooks(tables, classify=None):
    """(fetch_rows, classify) of the plain step: the fused layout's
    gathered meta/slab rows and ``classify_emit_plain``, or, with a
    ``classify`` hook (the 12-array layout), the ids as they are."""
    if classify is not None:
        return (lambda cands, tgts: (cands, tgts)), classify
    meta, slab = tables["meta"], tables["slab"]

    def fetch_rows(cands, tgts):
        c, t = cands.long(), tgts.long()
        return meta[c], meta[t], slab[c]
    return fetch_rows, classify_emit_plain


# ---------------------------------------------------------------- state
class StepState:
    """The loop's state for Q queries over n nodes at ``cap``: ``state``
    holds the control words then ``pos`` [Q]; ``front`` [cap] (dense:
    ``ctl[N_FRONT]`` entries); ``slots`` [≥ cap + 1]; ``visited`` and, with
    a COO tail, ``fbits`` [Q, ceil(n/32)]; ``log`` of the keys marked
    visited; the call's inputs (``cs``, ``ct``, ``pad``: a graph reads
    these buffers). On a card also kernel 3's look-back words
    (``status``) and kernel 4's verdicts of the multi-block form."""

    graph = None         # the executable graph's handle, once built
    tables = None        # the tables a call reads (ct: the state's copy)
    mark = None          # mark(label, sync=True): a graph call's boundaries

    def __init__(self, *, q: int, n_nodes: int, w: int, m_t: int, cap: int,
                 max_steps: int, device):
        self.shape = dict(q=q, n_nodes=n_nodes, w=w, m_t=m_t, cap=cap,
                          max_steps=max_steps)
        self.q, self.n, self.w, self.m_t = q, n_nodes, w, m_t
        self.cap, self.max_steps = cap, max_steps
        self.vbits = check_key_space(n_nodes, q, cap)
        self.n_words = (n_nodes + 31) // 32
        self.max_candidates = cap * w + q * m_t
        if self.max_candidates >= MAX_CANDIDATES:
            raise ValueError(
                f"{self.max_candidates} candidates a step (cap {cap} x W {w} "
                f"+ {q} queries x {m_t} tail edges) exceed kernel 3's "
                f"{MAX_CANDIDATES}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        i32 = dict(dtype=torch.int32, device=self.device)
        self.state = torch.zeros(CTL_WORDS + q, **i32)
        self.ctl, self.pos = self.state[:CTL_WORDS], self.state[CTL_WORDS:]
        self.front = torch.full((cap,), SENTINEL, **i32)
        self.slots = torch.full((cap + 1,), SENTINEL, **i32)
        self.visited = torch.zeros((q, self.n_words), **i32)
        self.fbits = (torch.zeros((q, self.n_words), **i32) if m_t
                      else None)
        # each step marks at most cap keys, and a (query, node) pair once
        self.log = torch.zeros(
            min(q + cap * max_steps, q * n_nodes, q + LOG_MAX), **i32)
        self.cs = torch.zeros(q, **i32)
        self.ct = torch.zeros(q, **i32)
        self.pad = torch.zeros(q, dtype=torch.bool, device=self.device)
        # the launch counters as the last graph call read them
        self.counted = np.zeros(4, np.uint32)
        if self.device.type == "cuda":
            self.status = torch.zeros(
                -(-self.max_candidates // PROBE_TILE), dtype=torch.int64,
                device=self.device)
            self.uniq = torch.full((cap + 1,), SENTINEL, **i32)
            self.verdict = torch.zeros(cap, **i32)

    def clone(self, device=None) -> "StepState":
        """A copy of the state on ``device`` (this one's by default),
        without its graph."""
        out = StepState(**self.shape, device=device or self.device)
        for name in ("state", "front", "visited", "fbits", "log", "cs",
                     "ct", "pad", "uniq", "verdict"):
            src, dst = getattr(self, name, None), getattr(out, name, None)
            if src is not None and dst is not None:
                dst.copy_(src)
        out.slots = self.slots.to(out.device, copy=True)
        return out

    def ensure_slots(self, n: int) -> None:
        """At least ``n`` slots (the distinct-count rule keeps every
        survivor)."""
        if self.slots.shape[0] < n:
            self.slots = torch.full((n,), SENTINEL, dtype=torch.int32,
                                    device=self.device)

    def args(self, tables: dict, **extra) -> ctypes.Array:
        """The int64 argument vector of ``csrc/frontier.cu``'s entry
        points: pointers of the state's and ``tables``' tensors (0 where
        absent), then sizes."""
        vals = dict(n_words=self.n_words, slot_cap=self.slots.shape[0],
                    log_cap=self.log.shape[0],
                    max_tiles=self.status.shape[0], q=self.q, w=self.w,
                    m_t=self.m_t, cap=self.cap, vbits=self.vbits,
                    max_steps=self.max_steps)
        for name in ("state", "front", "slots", "status", "visited",
                     "fbits", "log", "cs", "ct", "pad", "uniq", "verdict"):
            t = getattr(self, name)
            vals["ctl" if name == "state" else name] = (
                0 if t is None else t.data_ptr())
        for name, t in tables.items():
            vals[name] = 0 if t is None else t.data_ptr()
        slab = tables.get("slab")
        vals["k"] = 0 if slab is None else slab.shape[1] // 2
        vals.update(extra)
        return (ctypes.c_int64 * len(ARG_FIELDS))(
            *(int(vals.get(name, 0)) for name in ARG_FIELDS))

    def read(self):
        """A copy of the control words and pos on the host (numpy): one
        device-to-host copy (a sync on a card)."""
        if self.device.type == "cuda":
            STEPS["syncs"] += 1
        return self.state.to("cpu", copy=True).numpy()


def _put(ctl, words: dict) -> None:
    for index, value in words.items():
        ctl[index] = int(value)


def _hub_rows(st, is_hub, qs, vs, clear: bool = False) -> bool:
    """Sets (or clears) the frontier bits of the hub entries among (qs,
    vs); True if there is one."""
    if st.fbits is None:
        return False
    h = is_hub[vs.long()]
    qs, vs = qs[h], vs[h]
    bits = _bit(vs)
    # the bits are set and disjoint: subtracting them clears them
    or_bits(st.fbits, qs, vs >> 5, -bits if clear else bits)
    return bool(h.any())


# ------------------------------------------------------ set-up, clean-up
def setup_plain(st, cs, pad, is_hub) -> None:
    """The first front (non-padded queries in order), the sources' visited
    and hub bits, the log, pos zeroed, the control words."""
    qi = torch.arange(st.q, dtype=torch.int32, device=cs.device)
    live = ~pad
    qs, vs = qi[live], cs[live]
    keys = (qs << st.vbits) | vs
    n0 = keys.shape[0]
    st.pos.zero_()
    st.front[:n0] = keys
    st.log[:n0] = keys
    or_bits(st.visited, qs, vs >> 5, _bit(vs))
    hub = _hub_rows(st, is_hub, qs, vs)
    _put(st.ctl, {RUN: n0 > 0 and st.max_steps > 0, N_FRONT: n0, HUB: hub,
                  OVF: 0, STEP: 0, RAW: 0, TILE: 0,
                  EPOCH: int(st.ctl[EPOCH]) + 1, LOG_N: n0, M_NEW: 0})


def _args_launch(name, fn, st, tables, *extra) -> None:
    args = st.args(tables)           # alive until the launch returns
    _lib.launch(name, fn, st.device, ctypes.addressof(args), *extra)


def frontier_setup(st, cs, pad, is_hub, tables: dict) -> None:
    """``setup_plain`` by the set-up kernel on a card (a helper launch, no
    reference kernel: counted in ``STEPS["helpers"]``)."""
    if on_cpu(st.state):
        return setup_plain(st, cs, pad, is_hub)
    st.cs.copy_(cs)
    st.pad.copy_(pad)
    _args_launch(None, "reach_frontier_setup", st, tables)
    STEPS["helpers"] += 1


def frontier_cleanup(st, tables: dict) -> None:
    """Zeroes the visited words of every logged key (all of them when the
    call marked more keys than the log holds) and the last front's hub-bit
    words: the bitsets are zero for the next call."""
    if on_cpu(st.state):
        ctl = st.ctl.tolist()
        if ctl[LOG_N] > st.log.shape[0]:
            st.visited.zero_()
        else:
            keys = st.log[:ctl[LOG_N]]
            st.visited[(keys >> st.vbits).long(),
                       ((keys & ((1 << st.vbits) - 1)) >> 5).long()] = 0
        if st.fbits is not None:
            f = st.front[:ctl[N_FRONT]]
            st.fbits[(f >> st.vbits).long(),
                     ((f & ((1 << st.vbits) - 1)) >> 5).long()] = 0
        return
    _args_launch(None, "reach_frontier_cleanup", st, tables)
    STEPS["helpers"] += 1


# ---------------------------------------------------------------- kernel 3
def expand_probe_plain(st, ell, tail_src, tail_dst, *,
                       gather_rows=_take) -> None:
    """Kernel 3's plain version: the front's candidates, probed, compacted
    in candidate order into ``st.slots`` (SENTINEL-filled first; survivors
    beyond its length dropped), and their raw count into ``ctl[RAW]``."""
    ctl = st.ctl.tolist()
    st.slots.fill_(SENTINEL)
    if not ctl[RUN]:
        return
    q, w, vbits = st.q, st.w, st.vbits
    front = st.front[:ctl[N_FRONT]]
    fvalid = front != SENTINEL
    fq = torch.where(fvalid, front >> vbits, 0)
    fv = torch.where(fvalid, front & ((1 << vbits) - 1), 0)
    nbr = gather_rows(ell, fv)                          # [n_front, W]
    cq = fq[:, None].expand(-1, w).reshape(-1)
    cv = nbr.reshape(-1)
    ok = (fvalid[:, None] & (nbr >= 0)).reshape(-1)
    keys = probe_plain(cq.contiguous(), cv.contiguous(), ok.to(torch.int32),
                       st.visited, st.pos, vbits)
    found = [keys[keys != SENTINEL]]
    if ctl[HUB] and st.fbits is not None:
        # heavy tail: edge-parallel sweep gated by the frontier bitset, in
        # query order, a block of queries at a time (q x m_t candidates)
        word, bit = (tail_src >> 5).long(), (tail_src & 31)[None, :]
        block = max(1, TAIL_BLOCK // max(1, st.m_t))
        for q0 in range(0, q, block):
            qi = torch.arange(q0, min(q, q0 + block), dtype=torch.int32,
                              device=cq.device)
            act = (st.fbits[qi.long()][:, word] >> bit) & 1
            keys = probe_plain(
                qi[:, None].expand(-1, st.m_t).reshape(-1),
                tail_dst[None, :].expand(qi.numel(), -1).reshape(-1),
                act.reshape(-1), st.visited, st.pos, vbits)
            found.append(keys[keys != SENTINEL])
    found = torch.cat(found)
    kept = min(found.numel(), st.slots.shape[0])
    st.slots[:kept] = found[:kept]
    st.ctl[RAW] = found.numel()


def expand_probe_rows_plain(st, rows, tail_src, tail_dst) -> None:
    """The exchanged-rows entry's plain version: ``expand_probe_plain``
    with the front's ELL rows taken from ``rows`` [n_front, W]."""
    expand_probe_plain(st, None, tail_src, tail_dst,
                       gather_rows=lambda table, ids: rows)


def front_rows(st, ell, n_front: int, gather_rows):
    """The ELL rows [n_front, W] int32 of the front's nodes, in front
    order, through ``gather_rows(ell, node ids)``."""
    f = st.front[:n_front]
    fv = torch.where(f != SENTINEL, f & ((1 << st.vbits) - 1), 0)
    return gather_rows(ell, fv).to(torch.int32).contiguous()


def expand_probe(st, tables: dict, *, gather_rows=_take,
                 n_front=None) -> None:
    """Kernel 3 on ``st``: the step's survivors in ``st.slots``, their
    count in ``ctl[RAW]``. ``tables`` holds ell, tail_src, tail_dst,
    is_hub (and the rest kernel 4 reads). ``gather_rows(ell, ids)``: the
    ELL rows by global node id. The default reads the table in place (the
    kernel on a card); any other hook (the sharded placement's exchange)
    is called on the front's ``n_front`` nodes, and on a card the
    exchanged-rows entry reads its result."""
    if on_cpu(st.state):
        return expand_probe_plain(st, tables["ell"], tables["tail_src"],
                                  tables["tail_dst"], gather_rows=gather_rows)
    st.slots.fill_(SENTINEL)
    if gather_rows is _take:
        _args_launch("probe", "reach_expand_probe", st, tables)
    else:
        if n_front is None:
            raise ValueError("expand_probe with a gather_rows hook needs "
                             "the front's length")
        rows = front_rows(st, tables["ell"], n_front, gather_rows)
        _lib.check(rows, "rows", (n_front, st.w), st.device)
        args = st.args(tables, rows=rows.data_ptr())
        _lib.launch("probe_rows", "reach_expand_probe_rows", st.device,
                    ctypes.addressof(args))
    STEPS["launches"] += 1


# ---------------------------------------------------------------- kernel 4
def overlay_verdict_plain(verdict, nv, can_reach_tail):
    """The live overlay's rule (kernel 4's ``overlay_verdict``): NEG
    where ``can_reach_tail[nv]`` ([n] bool) turns UNKNOWN."""
    reopen = (verdict == ref.NEG) & can_reach_tail[nv.long()]
    return torch.where(reopen, ref.UNKNOWN, verdict).to(torch.int32)


def dedup_classify_emit_plain(st, ct, is_hub, *, fetch_rows, classify,
                              distinct_overflow: bool = False,
                              can_reach_tail=None) -> None:
    """Kernel 4's plain version: the sorted unique of the slots, overflow,
    ``classify(*fetch_rows(nv, nt), keys, eq)`` → (verdict, front keys),
    with a live overlay's ``can_reach_tail`` its rule
    (``overlay_verdict_plain``), the answered flags and visited bits of
    the live keys, the next front (dense, with its hub bits; the old
    front's cleared) and the control words. ``distinct_overflow``: the
    unique runs over every survivor and only more than cap distinct keys
    overflow."""
    ctl = st.ctl.tolist()
    if not ctl[RUN]:
        return
    cap, vbits, raw = st.cap, st.vbits, ctl[RAW]
    n = raw if distinct_overflow else min(raw, cap + 1)
    buf = torch.full((max(n, cap + 1),), SENTINEL, dtype=torch.int32,
                     device=st.slots.device)
    buf[:n] = st.slots[:n]
    uniq = unique_fixed(buf)[:cap + 1]
    ovf = bool(ctl[OVF] or (not distinct_overflow and raw > cap + 1)
               or uniq[cap] != SENTINEL)
    new = uniq[:cap]
    nvalid = new != SENTINEL
    m = int(nvalid.sum())
    nq = torch.where(nvalid, new >> vbits, 0)
    nv = torch.where(nvalid, new & ((1 << vbits) - 1), 0)
    nt = ct[nq.long()]                        # target node ids
    verdict, fkey = classify(*fetch_rows(nv, nt), new,
                             (nv == nt).to(torch.int32))
    if can_reach_tail is not None:
        verdict, fkey = emit_plain(
            overlay_verdict_plain(verdict, nv, can_reach_tail), new)
    old = st.front[:ctl[N_FRONT]]
    old = old[old != SENTINEL]
    _hub_rows(st, is_hub, old >> vbits, old & ((1 << vbits) - 1), clear=True)
    # live keys only: no dead slot scatters into word [0, 0]
    st.pos[nq[nvalid & (verdict == ref.POS)].long()] = 1
    or_bits(st.visited, nq[nvalid], nv[nvalid] >> 5, _bit(nv[nvalid]))
    logged = max(0, min(m, st.log.shape[0] - ctl[LOG_N]))
    st.log[ctl[LOG_N]:ctl[LOG_N] + logged] = new[:logged]
    keep = (fkey != SENTINEL) & (st.pos[nq.long()] == 0)
    nxt = new[keep]
    st.front[:nxt.shape[0]] = nxt
    hub = _hub_rows(st, is_hub, nq[keep], nv[keep])
    step = ctl[STEP] + 1
    _put(st.ctl, {RUN: nxt.shape[0] > 0 and not ovf and step < st.max_steps,
                  N_FRONT: nxt.shape[0], HUB: hub, OVF: ovf, STEP: step,
                  RAW: 0, TILE: 0, EPOCH: ctl[EPOCH] + 1,
                  LOG_N: ctl[LOG_N] + m, M_NEW: 0})


def dedup_classify_emit(st, tables: dict, *, classify=None,
                        distinct_overflow: bool = False,
                        fetch_rows=None) -> None:
    """Kernel 4 on ``st``, with ``tables`` (ct, is_hub, and meta, slab on
    the fused layout, where kernel 4 classifies from the rows in place;
    ``can_reach_tail`` under a live overlay, read in place for its rule).
    Up to ``SORT_MAX_CAP`` on the fused layout one block sorts the slots;
    above it, and for the 12-array layout (``classify(cands, tgts, keys,
    eq)`` → (verdict, front), kernel 2's verdicts), ``unique_fixed`` sorts
    the SENTINEL-filled slots and kernel 4 runs as mark and emit.
    ``fetch_rows``: the plain version's hook (``plain_hooks``' by
    default)."""
    if on_cpu(st.state):
        default_fetch, classify = plain_hooks(tables, classify)
        fetch_rows = fetch_rows or default_fetch
        return dedup_classify_emit_plain(
            st, tables["ct"], tables["is_hub"], fetch_rows=fetch_rows,
            classify=classify, distinct_overflow=distinct_overflow,
            can_reach_tail=tables.get("can_reach_tail"))
    if classify is None and not distinct_overflow and st.cap <= SORT_MAX_CAP:
        _args_launch("classify_emit", "reach_dedup_classify_emit", st,
                     tables)
        STEPS["launches"] += 1
        return
    st.uniq.copy_(unique_fixed(st.slots)[:st.cap + 1])
    extra = {}
    if classify is not None:
        new = st.uniq[:st.cap]
        nvalid = new != SENTINEL
        vbits = st.vbits
        nv = torch.where(nvalid, new & ((1 << vbits) - 1), 0)
        nt = tables["ct"][torch.where(nvalid, new >> vbits, 0).long()]
        verdict = classify(nv, nt, new, (nv == nt).to(torch.int32))[0]
        extra["verdict_in"] = _lib.check(verdict, "verdict", (st.cap,),
                                         st.device)
    args = st.args(tables, **extra)
    _lib.launch("classify_emit", "reach_frontier_mark", st.device,
                ctypes.addressof(args), int(distinct_overflow))
    _lib.launch("classify_emit", "reach_frontier_emit", st.device,
                ctypes.addressof(args))
    STEPS["launches"] += 2


# -------------------------------------------------------------- the loop
def _tables(ell, tail_src, tail_dst, is_hub, ct, tables,
            can_reach_tail=None) -> dict:
    """The tables of a call (``ct`` the state's copy), each checked on a
    card."""
    out = {"ell": ell, "tail_src": tail_src, "tail_dst": tail_dst,
           "is_hub": is_hub, "ct": ct, "meta": None, "slab": None,
           "can_reach_tail": can_reach_tail}
    if tables is not None:
        out.update(meta=tables["meta"], slab=tables["slab"])
    if ell.device.type == "cuda":
        for name, t in out.items():
            if t is not None:
                _lib.check(t, name, None, ell.device,
                           align=16 if name == "meta" else 4,
                           dtype=("bool" if name in ("is_hub",
                                                     "can_reach_tail")
                                  else "int32"))
    return out


def _no_mark(label, sync=True) -> None:
    pass


def _graph_call(st, cs, ct, pad) -> np.ndarray:
    """One expansion call as st's graph: the inputs copied in, one launch,
    one read-back. Kernels 3 and 4, set-up and clean-up are counted from
    their own launch counters. ``st.mark`` (chip_smoke.py's host split) is
    called at each boundary."""
    mark = st.mark or _no_mark
    mark("call")
    if st.graph is None:
        handle = ctypes.c_int64(0)
        args = st.args(st.tables)    # copied into the graph's nodes
        err = _lib.LIBRARY.get().reach_frontier_graph(
            ctypes.addressof(args), ctypes.addressof(handle))
        if err != 0:
            raise RuntimeError(f"reach_frontier_graph failed: CUDA error "
                               f"{err}")
        st.graph = handle.value
        weakref.finalize(st, _lib.LIBRARY.get().reach_frontier_graph_destroy,
                         st.graph)
    st.cs.copy_(cs)
    st.ct.copy_(ct)
    st.pad.copy_(pad)
    mark("inputs")
    err = _lib.LIBRARY.get().reach_frontier_graph_launch(
        st.graph, torch.cuda.current_stream(st.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frontier graph launch failed: CUDA error {err}")
    mark("enqueue", sync=False)
    mark("run")
    host = st.read()
    mark("read")
    words = host[LAUNCH_WORDS].view(np.uint32)
    setup, probe, classify, cleanup = (int(x) for x in words - st.counted)
    st.counted = words.copy()
    _lib.LAUNCHES["probe"] += probe
    _lib.LAUNCHES["classify_emit"] += classify
    STEPS["launches"] += probe + classify
    STEPS["helpers"] += setup + cleanup
    return host


def _stepped_call(st, tables, cs, ct, pad, *, classify=None,
                  distinct_overflow: bool = False, gather_rows=_take,
                  fetch_rows=None, on_step=None) -> np.ndarray:
    """One expansion call stepped from the host: set-up, then kernel 3 and
    kernel 4 while the control words say run (one read a step), then
    clean-up. Under ``distinct_overflow`` the slots first grow to every
    candidate of the step. ``gather_rows`` goes to kernel 3 (on a card
    its exchanged-rows entry, ``expand_probe``), ``fetch_rows`` to kernel
    4's plain version; ``on_step(st)`` sees the state before each step."""
    st.ct.copy_(ct)
    frontier_setup(st, cs, pad, tables["is_hub"], tables)
    while True:
        host = st.read()
        if not host[RUN]:
            break
        if distinct_overflow:
            st.ensure_slots(int(host[N_FRONT]) * st.w
                            + (st.q * st.m_t if host[HUB] else 0))
        if on_step is not None:
            on_step(st)
        expand_probe(st, tables, gather_rows=gather_rows,
                     n_front=int(host[N_FRONT]))
        dedup_classify_emit(st, tables, classify=classify,
                            distinct_overflow=distinct_overflow,
                            fetch_rows=fetch_rows)
    frontier_cleanup(st, tables)
    return host


def expand_frontier_loop_fused(ell, tail_src, tail_dst, is_hub, cs, ct,
                               pad, *, n_nodes: int, max_steps: int,
                               cap: int, gather_rows=_take, fetch_rows=None,
                               classify=None, tables=None,
                               distinct_overflow: bool = False,
                               can_reach_tail=None, workspaces=None):
    """The BFS loop over one chunk of Q queries.

    ell [n, W], tail_src/tail_dst [m_t], cs/ct [Q] int32; is_hub [n] and
    pad [Q] bool. ``tables`` (meta, slab) selects the fused layout, which
    kernel 4 classifies from in place on a card; without it
    ``classify(*fetch_rows(cands, tgts), keys, eq)`` → (verdict, front)
    classifies the survivors (kernel 2 on the 12-array layout), and
    ``distinct_overflow`` selects the overflow rule of the reference's XLA
    loop (``kernels/frontier.py``): overflow iff more than ``cap``
    distinct survivor keys. ``gather_rows(table, ids)`` and ``fetch_rows``
    are the loop's hooks (rows by global node id; the operands of
    ``classify``) for a sharded placement: on a card a ``gather_rows``
    hook feeds kernel 3's exchanged-rows entry; without one the kernels
    read the tables in place. ``can_reach_tail`` ([n] bool) is a
    live overlay's: kernel 4 applies its rule to every verdict, the graph
    path included (union-graph serving; ``tail_src``/``tail_dst`` then
    carry the delta slab). ``workspaces`` (required on a card): a dict
    in which the state (zeroed bitsets, graphs) is kept across calls, one
    entry per shape and tables. Returns (pos [Q] bool on the host,
    overflow).
    """
    q, w, m_t = cs.shape[0], ell.shape[1], int(tail_src.shape[0])
    check_key_space(n_nodes, q, cap)
    if tables is None and classify is None:
        raise ValueError("expand_frontier_loop_fused needs the fused "
                         "tables or a classify hook")
    shape = dict(q=q, n_nodes=n_nodes, w=w, m_t=m_t, cap=cap,
                 max_steps=max_steps)
    graph = (not on_cpu(cs) and tables is not None and not distinct_overflow
             and cap <= SORT_MAX_CAP)
    if workspaces is None:
        if not on_cpu(cs):
            raise ValueError("expand_frontier_loop_fused on a card needs "
                             "workspaces (a dict kept across calls)")
        st = StepState(**shape, device="cpu")
        st.tables = _tables(ell, tail_src, tail_dst, is_hub, st.ct, tables,
                            can_reach_tail)
    else:
        meta, slab = (None, None) if tables is None else (tables["meta"],
                                                          tables["slab"])
        key = (graph, cs.device, *shape.values(),
               *(None if t is None else t.data_ptr()
                 for t in (ell, tail_src, tail_dst, is_hub, meta, slab,
                           can_reach_tail)))
        st = workspaces.get(key)
        if st is None:
            st = StepState(**shape, device=cs.device)
            st.tables = _tables(ell, tail_src, tail_dst, is_hub, st.ct,
                                tables, can_reach_tail)
            workspaces[key] = st
    if graph:
        host = _graph_call(st, cs, ct, pad)
    else:
        host = _stepped_call(
            st, st.tables, cs, ct, pad, classify=classify,
            distinct_overflow=distinct_overflow, gather_rows=gather_rows,
            fetch_rows=fetch_rows)
    STEPS["steps"] += int(host[STEP])
    return torch.from_numpy(host[CTL_WORDS:] != 0), bool(host[OVF])
