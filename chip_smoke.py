#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version bit for bit, then drives the port's
serving path through ``repro_torch.reach.QuerySession`` on the card:

  main     the default IndexSpec (k=2, FERRARI-G, c=4, 32 seeds: k_max ≤ 8,
           one seed word, ELL width ≤ 32 — the ferrari-web widths) over
           scale_free_digraph(4M, 4.0); 2^20 random + 2^17 positive
           queries in micro-batches of 16384 (kernel 1).
  phase2   a weak index (k=1, no seeds) over 1M nodes with the sparse
           phase 2, at the default frontier cap and at cap 256, which
           forces the overflow retry (kernels 1, 3, 4).
  seeds64  a weak index (k=1) with 64 seeds over 1M nodes: the 12-array
           layout, in phase 1 and in the sparse phase 2 (kernels 2, 3).
  dense    the dense phase 2 on a graph of ≤ 8192 condensed nodes.

Every phase sets the launch counters to 0 just before it is driven and
reads them just after, and holds its answers against the host guided DFS
(``core.query.QueryEngine``). Any mismatch or exception exits non-zero.
The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": ...}``. Without a CUDA device,
or without the repository's ``src/`` beside this file, it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
ALU_OPS_PER_S = 67e12          # 32-bit non-tensor peak (H100 SXM)
PARITY_ROWS = 1 << 20
MAIN_NODES = 4_000_000
SIDE_NODES = 1_000_000

KERNELS = {
    "stab_packed": dict(
        source="src/repro_torch/csrc/interval_stab.cu",
        replaces="src/repro/kernels/interval_stab.py:117", phase="main"),
    "stab_naive": dict(
        source="src/repro_torch/csrc/interval_stab.cu",
        replaces="src/repro/kernels/interval_stab.py:149", phase="seeds64"),
    "probe": dict(
        source="src/repro_torch/csrc/frontier.cu",
        replaces="src/repro/kernels/frontier_fused.py:60", phase="phase2"),
    "classify_emit": dict(
        source="src/repro_torch/csrc/frontier.cu",
        replaces="src/repro/kernels/frontier_fused.py:78", phase="phase2"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ inputs ----
def _seed_words(g, shape, dev):
    import torch
    bit = torch.randint(0, 32, shape, generator=g, device=dev,
                        dtype=torch.int32)
    word = torch.where(bit == 31, torch.iinfo(torch.int32).min,
                       torch.bitwise_left_shift(torch.ones_like(bit),
                                                bit.clamp(max=30)))
    on = torch.rand(shape, generator=g, device=dev) < 0.3
    return torch.where(on, word, 0).to(torch.int32)


def packed_tables(g, n, k, dev):
    """Random meta [n, 4] / slab [n, 2K] rows: levels across the sign bit
    and saturated at 255, exact flags in the begins' sign bit, INVALID
    pads, sparse seed words, intervals placed around other rows' π."""
    import torch
    i32 = dict(device=dev, dtype=torch.int32)
    pi = torch.randint(0, 1 << 24, (n,), generator=g, **i32)
    lvl = torch.tensor([0, 1, 5, 127, 128, 200, 254, 255], **i32)[
        torch.randint(0, 8, (n,), generator=g, device=dev)]
    # level byte over the sign bit: build the word in int64, wrap to int32
    word0 = (pi.long() | (lvl.long() << 24)).to(torch.int32)
    tau = torch.randint(0, 1000, (n,), generator=g, **i32)
    meta = torch.stack([word0, tau, _seed_words(g, (n,), dev),
                        _seed_words(g, (n,), dev)], dim=1).contiguous()
    near = pi[torch.randint(0, n, (n, k), generator=g, device=dev)]
    b = (near - torch.randint(0, 8, (n, k), generator=g, **i32)).clamp(min=0)
    e = near + torch.randint(0, 8, (n, k), generator=g, **i32)
    far = torch.rand((n, k), generator=g, device=dev) < 0.5
    b = torch.where(far, torch.randint(0, 1 << 24, (n, k), generator=g,
                                       **i32), b)
    e = torch.where(far, b + torch.randint(0, 1 << 20, (n, k), generator=g,
                                           **i32), e)
    invalid = torch.rand((n, k), generator=g, device=dev) < 0.2
    exact = (torch.rand((n, k), generator=g, device=dev) < 0.3) & ~invalid
    b = torch.where(invalid, 2**31 - 1, b)
    e = torch.where(invalid, -1, e)
    braw = torch.where(exact, b | torch.iinfo(torch.int32).min, b)
    return meta, torch.cat([braw, e], dim=1).contiguous()


def query_pairs(g, n, q, dev):
    import torch
    cs = torch.randint(0, n, (q,), generator=g, device=dev,
                       dtype=torch.int32)
    ct = torch.randint(0, n, (q,), generator=g, device=dev,
                       dtype=torch.int32)
    ct[: q // 8] = cs[: q // 8]                 # the cs == ct fold
    return cs, ct


def naive_tables(g, n, k, w, dev):
    import torch
    i32 = dict(device=dev, dtype=torch.int32)
    pi = torch.randint(0, 1 << 26, (n,), generator=g, **i32)
    tau = torch.randint(0, 1000, (n,), generator=g, **i32)
    lvl = torch.randint(0, 400, (n,), generator=g, **i32)
    near = pi[torch.randint(0, n, (n, k), generator=g, device=dev)]
    b = (near - torch.randint(0, 8, (n, k), generator=g, **i32)).clamp(min=0)
    e = near + torch.randint(0, 8, (n, k), generator=g, **i32)
    invalid = torch.rand((n, k), generator=g, device=dev) < 0.2
    b = torch.where(invalid, 2**31 - 1, b).contiguous()
    e = torch.where(invalid, -1, e).contiguous()
    x = ((torch.rand((n, k), generator=g, device=dev) < 0.3)
         & ~invalid).to(torch.int32)
    return (pi, tau, lvl, b, e, x, _seed_words(g, (n, w), dev),
            _seed_words(g, (n, w), dev))


# ------------------------------------------------------------ parity ----
def _compare(name, got, want):
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    bad = sum(int((a != b).sum()) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    rows = got[0].shape[0]
    print(f"  parity {name}: {rows} rows, {bad} mismatches", flush=True)
    check(bad == 0, f"{name} disagrees with its plain version")
    return err, bad


def _tally(total: dict, name: str, result) -> None:
    err, bad = result
    total[name] = (max(total[name][0], err), total[name][1] + bad)


def kernel_parity(dev) -> dict:
    """Each kernel against its plain version on ≥ 2^20 random rows:
    {name: (max_abs_err, mismatches)}."""
    import torch

    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.kernels import interval_stab as st
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    err = {name: (0, 0) for name in KERNELS}
    n = 1 << 22
    for k in (1, 8, 32):
        meta, slab = packed_tables(g, n, k, dev)
        cs, ct = query_pairs(g, n, PARITY_ROWS, dev)
        print(f"  stab_packed K={k}: saturated-level rows "
              f"{int(((meta[cs.long(), 0] >> 24) & 0xFF).eq(255).sum())}, "
              f"exact-flag slots {int((slab[cs.long(), :k] < 0).sum())}",
              flush=True)
        _tally(err, "stab_packed", _compare(
            f"stab_packed K={k}", st.stab_packed(meta, slab, cs, ct),
            st.stab_packed_plain(meta, slab, cs, ct)))
        tables = naive_tables(g, n, k, 2, dev)
        _tally(err, "stab_naive", _compare(
            f"stab_naive K={k} W=2", st.stab_naive(*tables, cs, ct),
            st.stab_naive_plain(*tables, cs, ct)))
        del meta, slab, tables
    # kernel 3: 2^20 candidates of 256 queries over a 2^20-node bitset
    q, nn, c = 256, 1 << 20, PARITY_ROWS
    i32 = dict(device=dev, dtype=torch.int32)
    cq = torch.randint(0, q, (c,), generator=g, **i32)
    cv = torch.randint(0, nn, (c,), generator=g, **i32)
    ok = (torch.rand(c, generator=g, device=dev) < 0.8).to(torch.int32)
    visited = torch.randint(-2**31, 2**31 - 1, (q, nn // 32), generator=g,
                            **i32)
    pos = (torch.rand(q, generator=g, device=dev) < 0.2).to(torch.int32)
    _tally(err, "probe", _compare(
        "probe", ff.probe(cq, cv, ok, visited, pos, 20),
        ff.probe_plain(cq, cv, ok, visited, pos, 20)))
    del visited
    # kernel 4: 2^20 survivors with their gathered rows, K = 8
    meta, slab = packed_tables(g, 1 << 20, 8, dev)
    cs, ct = query_pairs(g, 1 << 20, c, dev)
    keys = torch.randint(0, 2**30, (c,), generator=g, **i32)
    keys[::5] = 2**31 - 1
    args = (meta[cs.long()], meta[ct.long()], slab[cs.long()], keys,
            (cs == ct).to(torch.int32))
    _tally(err, "classify_emit", _compare(
        "classify_emit", ff.classify_emit(*args),
        ff.classify_emit_plain(*args)))
    return err


# ------------------------------------------------------------ timing ----
L2_FLUSH_BYTES = 256 << 20     # > the H100's 50 MB L2


def device_ms(fn, reps: int = 30, cold: bool = True) -> float:
    """Median device time of one call from a pair of CUDA events around
    each of ``reps`` calls. All are queued behind a sleep kernel, so host
    launch overhead opens no gaps. With ``cold``, a 256 MiB write before
    each call evicts the L2, so the call reads its inputs from device
    memory, as the bound assumes; without it, repeated calls on the same
    inputs find them in the L2."""
    import torch
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)           # ~50 ms of queued work
    for start, end in events:
        if cold:
            flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


class Recorder:
    """Wraps the kernel wrappers as the serving path calls them and keeps
    the inputs of the largest call of each, for timing at the path's own
    shapes. Counting stays in the wrappers themselves."""

    def __init__(self):
        from repro_torch.kernels import frontier_fused as ff
        from repro_torch.kernels import ops
        self.calls = {}
        self._orig = {}
        for mod, name in ((ops, "stab_packed"), (ops, "stab_naive"),
                          (ff, "probe"), (ops, "classify_emit")):
            fn = getattr(mod, name)
            self._orig[(mod, name)] = fn
            setattr(mod, name, self._wrap(name, fn))

    ROWS_ARG = {"stab_packed": -2, "stab_naive": -2, "probe": 0,
                "classify_emit": -1}

    def _wrap(self, name, fn):
        # references, not copies: copying would add to the served time;
        # only the probe's visited/pos change afterwards (same shapes)
        def wrapped(*args):
            rows = args[self.ROWS_ARG[name]].shape[0]
            if rows > self.calls.get(name, (0, None))[0]:
                self.calls[name] = (rows, args)
            return fn(*args)
        return wrapped

    def reset(self):
        self.calls = {}

    def close(self):
        for (mod, name), fn in self._orig.items():
            setattr(mod, name, fn)


def _distinct(*ids) -> int:
    import torch
    return int(torch.unique(torch.cat(ids)).numel())


def work_of(name, args):
    """(bytes, int32 ops) the call must move and do on this call's data.
    Each input element the result depends on is read once — a table row,
    bitset word or flag that several queries gather counts once — and
    each output is written once. Rows the result does not depend on are
    not counted: those of cs == ct pairs, of candidates with ok == 0 (and
    the answered flag of one already visited), of SENTINEL slots, and of
    slots that are their query's target."""
    if name == "stab_packed":
        meta, slab, cs, ct = args
        k = slab.shape[1] // 2
        live = cs != ct
        q, s, t = cs.shape[0], cs[live], ct[live]
        nbytes = q * 12 + _distinct(s, t) * 16 + _distinct(s) * 8 * k
        return nbytes, int(live.sum()) * (6 * k + 25) + q
    if name == "stab_naive":
        pi, tau, lvl, b, e, x, sp, sm, cs, ct = args
        k, w = b.shape[1], sp.shape[1]
        live = cs != ct
        q, s, t = cs.shape[0], cs[live], ct[live]
        nbytes = (q * 12 + _distinct(s, t) * (8 + 8 * w)
                  + _distinct(s) * 12 * k + _distinct(t) * 4)
        return nbytes, int(live.sum()) * (6 * k + 8 * w + 10) + q
    if name == "probe":
        cq, cv, ok, visited, pos, _ = args
        c, valid = cq.shape[0], ok != 0
        q, v = cq[valid].long(), cv[valid].long()
        word = visited[q, v >> 5]
        fresh = ((word >> (v & 31)) & 1) == 0
        nbytes = (c * 8 + int(valid.sum()) * 8
                  + _distinct(q * visited.shape[1] + (v >> 5)) * 4
                  + _distinct(q[fresh]) * 4)
        return nbytes, c * 2 + int(valid.sum()) * 10
    meta_s, meta_t, slab_s, keys, eq = args
    c, k = keys.shape[0], slab_s.shape[1] // 2
    live = keys != 2**31 - 1
    rows = int((live & (eq == 0)).sum())
    return (c * 12 + int(live.sum()) * 4 + rows * (32 + 8 * k),
            c * 2 + rows * (6 * k + 30))


def time_kernels(recorded: dict) -> dict:
    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.kernels import interval_stab as st
    plain = {"stab_packed": st.stab_packed_plain,
             "stab_naive": st.stab_naive_plain,
             "probe": ff.probe_plain, "classify_emit": ff.classify_emit_plain}
    kernel = {"stab_packed": st.stab_packed, "stab_naive": st.stab_naive,
              "probe": ff.probe, "classify_emit": ff.classify_emit}
    out = {}
    for name in KERNELS:
        rows, args = recorded[name]
        err = _compare(f"{name} on the path's inputs", kernel[name](*args),
                       plain[name](*args))
        ms = device_ms(lambda: kernel[name](*args))
        warm_ms = device_ms(lambda: kernel[name](*args), cold=False)
        plain_ms = device_ms(lambda: plain[name](*args))
        nbytes, ops = work_of(name, args)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        out[name] = dict(rows=rows, ms=ms, plain_ms=plain_ms,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", bytes=nbytes, err=err)
        print(f"  time {name}: {rows} rows, kernel {ms:.4f} ms (L2 cold; "
              f"{warm_ms:.4f} ms L2 warm), plain {plain_ms:.4f} ms, bound "
              f"{out[name]['bound_ms']:.6f} ms ({nbytes} B, "
              f"{out[name]['bound_by']}), {ms / max(rows, 1) * 1e6:.2f} "
              f"ns/row", flush=True)
    return out


# ------------------------------------------------------------ phases ----
def counters():
    from repro_torch.kernels import _lib
    from repro_torch.kernels import frontier_fused as ff
    return _lib.LAUNCHES, ff.STEPS


def reset_counters():
    for c in counters():
        c.reset()


def read_counters() -> dict:
    launches, steps = counters()
    return {**dict(launches), **{f"sparse_{k}": v for k, v in steps.items()}}


def make_session(g, spec, dev, built=None):
    """Host build + pack (or reuse ``built``) and a session on ``dev``."""
    from repro_torch.core.packed import pack_index
    from repro_torch.reach import QuerySession, build
    t0 = time.perf_counter()
    if built is None:
        ix = build(g, spec)
        pk = pack_index(ix)
        p2 = spec.phase2_mode
        if p2 == "auto":
            p2 = "dense" if pk.n <= spec.n_dense_max else "sparse"
        ell = pk.ell_layout(width=spec.ell_width) if p2 == "sparse" else None
    else:
        ix, pk, ell = built
    sess = QuerySession(ix, spec, packed=pk, ell=ell, device=dev)
    dt = time.perf_counter() - t0
    tail = 0 if ell is None else ell[1].size
    print(f"  index: {g.n} nodes -> {pk.n} condensed, k_max {pk.k_max}, "
          f"seed words {0 if pk.s_plus is None else pk.s_plus.shape[1]}, "
          f"fused layout {'slab' in sess.engine.dev}, ELL width "
          f"{None if ell is None else ell[0].shape[1]}, COO tail {tail}, "
          f"max level {int(pk.blevel.max())}, phase 2 "
          f"{sess.engine.phase2_mode}; host build + pack {dt:.1f} s",
          flush=True)
    return ix, sess, (ix, pk, ell)


def serve(sess, qs, qt, label):
    import torch
    sess.reset_stats()
    t0 = time.perf_counter()
    ans = sess.query(qs, qt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = sess.stats
    eng = sess.engine
    print(f"  {label}: {qs.size} queries in {dt * 1e3:.1f} ms "
          f"({dt / qs.size * 1e9:.0f} ns/query), {int(ans.sum())} positive; "
          f"mix phase1 pos/neg {st.phase1_pos}/{st.phase1_neg}, phase 2 "
          f"{st.phase2_queries} (dense {st.phase2_dense}, sparse "
          f"{st.phase2_sparse}, host {st.phase2_host}), sparse retries "
          f"{st.sparse_retries}; last batch phase1 "
          f"{eng.last_phase1_s * 1e3:.3f} ms, phase2 "
          f"{eng.last_phase2_s * 1e3:.3f} ms", flush=True)
    return ans, st


def profile_window(sess, qs, qt, label):
    """Where the time goes: device time by kernel and copy (torch.profiler,
    device-side events only) over one serve of ``qs``, against the wall
    time of the same serve without the profiler; their ratio is the
    device's busy share (one stream, so events do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.query(qs, qt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.query(qs, qt)
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  profile {label}: {qs.size} queries, wall {wall * 1e3:.2f} ms "
          f"unprofiled, device busy {busy * 1e3:.3f} ms "
          f"({busy / wall:.1%}); top device time:", flush=True)
    for us, count, key in rows[:6]:
        print(f"    {us / 1e3:9.3f} ms  x{count:<5} {key[:70]}", flush=True)


def hold_to_host(ix, sess, qs, qt, ans, n_sample, label):
    """The host guided DFS on a sample plus every phase-2 query."""
    from repro_torch.core.query import QueryEngine
    from repro_torch.kernels import ops
    v, _, _ = sess.engine.classify(qs, qt)
    unknown = np.flatnonzero(v.cpu().numpy() == ops.UNKNOWN)
    rng = np.random.default_rng(7)
    idx = np.union1d(rng.choice(qs.size, min(n_sample, qs.size),
                                replace=False), unknown)
    want = QueryEngine(ix).batch(qs[idx], qt[idx])
    bad = int((ans[idx] != want).sum())
    print(f"  host check {label}: {idx.size} answers ({unknown.size} from "
          f"phase 2), {bad} mismatches", flush=True)
    check(bad == 0, f"{label}: answers differ from the host engine")


def main_phase(dev, rec):
    from repro_torch.core.workload import positive_queries, random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print(f"main: scale_free_digraph({MAIN_NODES}, 4.0), default IndexSpec",
          flush=True)
    g = scale_free_digraph(MAIN_NODES, 4.0, seed=0)
    spec = IndexSpec()
    ix, sess, _ = make_session(g, spec, dev)
    check("slab" in sess.engine.dev and sess.engine.packed.k_max <= 8,
          "main index must take the fused layout with k_max <= 8")
    qs, qt = random_queries(g, 1 << 20, seed=1)
    ps, pt = positive_queries(g, 1 << 17, seed=2)
    sess.query(qs[:spec.max_batch], qt[:spec.max_batch])     # warm up
    reset_counters()
    rec.reset()
    ans, st_r = serve(sess, qs, qt, "random")
    ans_p, st_p = serve(sess, ps, pt, "positive")
    counts, calls = read_counters(), dict(rec.calls)
    print(f"  counts: {counts}; phase-1 batch shapes {sess.trace_count}",
          flush=True)
    check(bool(ans_p.all()), "main: a positive-workload answer is false")
    hold_to_host(ix, sess, qs, qt, ans, 10_000, "main random")
    profile_window(sess, qs[:1 << 18], qt[:1 << 18], "main random")
    return counts, calls


def phase2_phase(dev, rec):
    from repro_torch.core.workload import random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print(f"phase2: scale_free_digraph({SIDE_NODES}, 4.0), k=1, no seeds, "
          "sparse phase 2", flush=True)
    g = scale_free_digraph(SIDE_NODES, 4.0, seed=3)
    qs, qt = random_queries(g, 1 << 18, seed=4)
    out, built = {}, None
    for cap in (IndexSpec.frontier_cap, 256):
        spec = IndexSpec(k=1, use_seeds=False, phase2_mode="sparse",
                         frontier_cap=cap)
        ix, sess, built = make_session(g, spec, dev, built)
        sess.query(qs[:spec.max_batch], qt[:spec.max_batch])  # warm up
        reset_counters()
        rec.reset()
        ans, st = serve(sess, qs, qt, f"frontier_cap={cap}")
        counts, calls = read_counters(), dict(rec.calls)
        print(f"  counts: {counts}", flush=True)
        check(st.phase2_sparse > 0, "phase2: no sparse phase-2 traffic")
        if cap == 256:
            check(st.sparse_retries > 0, "phase2: cap 256 did not retry")
            print(f"  sparse_retries > 0: {st.sparse_retries}", flush=True)
        hold_to_host(ix, sess, qs, qt, ans, 2000, f"cap={cap}")
        profile_window(sess, qs, qt, f"cap={cap}")
        out.setdefault("counts", counts)
        out.setdefault("calls", calls)
        out.setdefault("answers", ans)
        check(np.array_equal(out["answers"], ans),
              "phase2: answers differ between the two caps")
    return out["counts"], out["calls"]


def seeds64_phase(dev, rec):
    from repro_torch.core.workload import random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print(f"seeds64: scale_free_digraph({SIDE_NODES}, 4.0), k=1, 64 seeds, "
          "sparse phase 2", flush=True)
    g = scale_free_digraph(SIDE_NODES, 4.0, seed=5)
    spec = IndexSpec(k=1, n_seeds=64, phase2_mode="sparse")
    ix, sess, _ = make_session(g, spec, dev)
    check("slab" not in sess.engine.dev, "seeds64 must use the 12-array "
          "layout")
    qs, qt = random_queries(g, 1 << 18, seed=6)
    sess.query(qs[:spec.max_batch], qt[:spec.max_batch])
    reset_counters()
    rec.reset()
    ans, st = serve(sess, qs, qt, "random")
    counts, calls = read_counters(), dict(rec.calls)
    print(f"  counts: {counts}", flush=True)
    check(st.phase2_sparse > 0, "seeds64: no sparse phase-2 traffic")
    check(counts["probe"] > 0, "seeds64: phase 2 did not launch kernel 3")
    hold_to_host(ix, sess, qs, qt, ans, 2000, "seeds64")
    return counts, calls


def dense_phase(dev, rec):
    from repro_torch.core.query import QueryEngine
    from repro_torch.core.workload import random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print("dense: scale_free_digraph(16000, 4.0), k=1, no seeds, dense "
          "phase 2", flush=True)
    g = scale_free_digraph(16_000, 4.0, seed=7)
    spec = IndexSpec(k=1, use_seeds=False, phase2_mode="dense")
    ix, sess, _ = make_session(g, spec, dev)
    check(sess.engine.packed.n <= 8192, "dense graph over 8192 nodes")
    qs, qt = random_queries(g, 1 << 15, seed=8)
    reset_counters()
    ans, st = serve(sess, qs, qt, "random")
    counts = read_counters()
    print(f"  counts: {counts}", flush=True)
    check(st.phase2_dense > 0, "dense: no dense phase-2 traffic")
    want = QueryEngine(ix).batch(qs, qt)
    bad = int((ans != want).sum())
    print(f"  host check dense: {qs.size} answers, {bad} mismatches",
          flush=True)
    check(bad == 0, "dense: answers differ from the host engine")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _lib
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {name}", flush=True)

    print("build:", flush=True)
    t0 = time.perf_counter()
    _lib.LIBRARY.get()
    print(f"  {_lib.LIBRARY.path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_lib.LIBRARY.build_seconds})", flush=True)
    for line in _lib.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    print("parity (kernel vs plain, bit for bit):", flush=True)
    err = kernel_parity(dev)

    rec = Recorder()
    try:
        main_counts, main_calls = main_phase(dev, rec)
        p2_counts, p2_calls = phase2_phase(dev, rec)
        s64_counts, s64_calls = seeds64_phase(dev, rec)
        dense_counts = dense_phase(dev, rec)
    finally:
        rec.close()
    phase_counts = {"main": main_counts, "phase2": p2_counts,
                    "seeds64": s64_counts, "dense": dense_counts}
    for kname, meta in KERNELS.items():
        n = phase_counts[meta["phase"]][kname]
        print(f"  launches {kname} on its phase ({meta['phase']}): {n}",
              flush=True)
        check(n > 0, f"{kname} was not launched on the {meta['phase']} "
              "phase")
    check(dense_counts["stab_packed"] > 0, "dense: kernel 1 not launched")
    print(f"  sparse steps/syncs on phase2: {p2_counts['sparse_steps']}/"
          f"{p2_counts['sparse_syncs']} (one host sync per BFS step, plus "
          "one per expansion call)", flush=True)

    print("times (CUDA events, the path's own inputs):", flush=True)
    recorded = {"stab_packed": main_calls["stab_packed"],
                "stab_naive": s64_calls["stab_naive"],
                "probe": p2_calls["probe"],
                "classify_emit": p2_calls["classify_emit"]}
    times = time_kernels(recorded)
    rows = []
    for kname, meta in KERNELS.items():
        t = times[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": phase_counts[meta["phase"]][kname],
            "max_abs_err": max(err[kname][0], t["err"][0]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    bad = {k: err[k][1] + times[k]["err"][1] for k in KERNELS}
    print("kernels: " + ", ".join(f"{r['name']} {bad[r['name']]} "
                                  f"mismatches, {r['launches']} launches"
                                  for r in rows)
          + f"; total {time.perf_counter() - t_start:.0f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
