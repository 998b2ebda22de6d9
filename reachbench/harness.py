"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the configuration's graph from the seed, builds its index with
``repro_torch.reach.build``, packs it with its ELL layout, opens a
``QuerySession`` and warms up the shapes the cell's traffic uses. The window
then drives the session (a ``closed`` mix: ``QuerySession.query`` back to
back) or a ``Frontend`` over it (an ``open`` mix: requests at their due
times) for ``--seconds``. After it the program's state is freed and the
plain reference (``reference.py``) answers a sample of the window's pairs
drawn from the seed; every answer the program gave to a sampled pair is
compared with it.

Metrics are read by ``metrics/<name>.py`` from a plain dict (``ctx``):

* ``cell``, ``config``, ``mix``: the entries and files of the run;
  ``device_kind``: the card's name (``cpu`` off the card);
* ``host``: the harness's clocks (``setup_s``, ``build_index_s``,
  ``build_pack_s``, ``window_s``, ``pairs``; an open loop's ``latency_s``
  and ``late_s`` per request, ``inf`` for a request never answered);
* ``session``: ``SessionStats`` over the window; ``frontend``:
  ``FrontendStats`` (open loops); ``traffic`` and ``calls``: a closed
  loop's pool (``traffic.Traffic``) and the pool calls it served, in
  order; ``steps``: the sparse phase 2's counters
  ``frontier_fused.STEPS`` over the window; ``launches``: the kernel
  launches the port counted over the window (``_lib.LAUNCHES``, kernel
  3's ``probe`` from its own launch counter inside a CUDA graph);
* ``trace`` (``--trace 1``): ``devtrace.summarize`` of the window.

A reader returns None where it finds nothing to read; the metric is then
left out of the line.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import sys
import time

import numpy as np

from . import devtrace, gen, manifest, reference, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
DRAIN_S = 60.0            # how long answers may come after the window


class Spans:
    """The harness's host spans around its calls into the program: a
    profiler range each in a traced window, nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(devtrace.PREFIX + name)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tenant(i: int) -> str:
    return f"tenant-{i}"


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (``inf`` counts as the
    largest)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(0, math.ceil(q / 100 * v.size) - 1)])


def p99(values) -> float:
    return percentile(values, 99)


def setup(cfg: dict, mix: dict, seed: int, seconds: float, device, spans):
    """Everything before the window. Returns the session, the edge lists
    (n, src, dst), the out-edge tables (n, indptr, indices), the window's
    traffic and the run's record."""
    from repro_torch import reach
    from repro_torch.core.packed import pack_index
    from repro_torch.graphs.csr import CSR
    host = {}
    t0 = time.perf_counter()
    with spans("setup.graph"):
        n, src, dst = gen.make_graph(cfg["graph"], seed)
        indptr, indices = gen.csr_arrays(n, src, dst, device)
        graph = CSR(n=n, indptr=indptr, indices=indices)
    host["graph_s"] = time.perf_counter() - t0
    spec = reach.IndexSpec(**cfg["index"])
    t0 = time.perf_counter()
    with spans("setup.build"):
        ix = reach.build(graph, spec, device=device)
        _sync(device)
    host["build_index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with spans("setup.pack"):
        pk = pack_index(ix, k_max=int(cfg["k_max"]))
        ell = pk.ell_layout(width=spec.ell_width)
    host["build_pack_s"] = time.perf_counter() - t0
    host["coo_tail_edges"] = int(ell[1].size)
    t0 = time.perf_counter()
    with spans("setup.session"):
        sess = reach.QuerySession(ix, spec, packed=pk, ell=ell, device=device)
    del graph, pk, ell
    with spans("setup.traffic"):
        tables = (n, indptr, indices)
        win = traffic.window(tables, mix, seed, seconds)
        warm = traffic.warmup(tables, mix, seed, int(mix["warmup_pairs"]))
    host["session_traffic_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with spans("setup.warmup"):
        _warm_up(sess, spec, mix, warm)
        _sync(device)
    host["warmup_s"] = time.perf_counter() - t0
    return sess, (n, src, dst), tables, win, host


def _warm_up(sess, spec, mix: dict, warm) -> None:
    """The shapes the window will use. A closed loop's calls are full
    micro-batches and the phase-2 chunks they leave, so one call of the
    warm-up's pairs (a few micro-batches) warms them; an open loop warms
    every power-of-two bucket a slab can take, then a burst through a
    frontend of its own."""
    from repro_torch.reach import Frontend
    if mix["loop"] == "closed":
        sess.query(warm.s, warm.t)
    else:
        b = spec.min_bucket
        while b <= spec.max_batch:
            sess.query(warm.s[:b], warm.t[:b])
            b <<= 1
        fe = Frontend(sess)
        blk = warm.block
        for i in range(warm.n_blocks):
            fe.submit(_tenant(i % int(mix["tenants"])),
                      warm.s[i * blk:(i + 1) * blk],
                      warm.t[i * blk:(i + 1) * blk])
            if fe.router.pending_queries >= spec.max_batch:
                fe.poll(force=True)
        fe.drain()
    sess.reset_stats()


def closed_loop(sess, win, mix: dict, seconds: float, spans, clock,
                in_call):
    """``QuerySession.query`` back to back on the pool's calls in turn,
    until a call ends past ``seconds``. ``in_call[c]``: the sampled rows of
    pool call c, counted from its first pair. Returns (calls served, each
    call's answers at its sampled rows, elapsed s)."""
    q = int(mix["pairs_per_call"])
    n_pool = win.s.size // q
    calls, answers = [], []
    t0 = clock()
    while True:
        c = len(calls) % n_pool
        with spans("bulk.query"):
            ans = sess.query(win.s[c * q:(c + 1) * q], win.t[c * q:(c + 1) * q])
        calls.append(c)
        answers.append(ans[in_call[c]])
        if clock() - t0 >= seconds:
            break
    return calls, answers, clock() - t0


def open_loop(fe, win, seconds: float, spans, clock, keep):
    """Requests submitted at their due times, the frontend polled between
    them, then drained for up to ``DRAIN_S``. A request the frontend
    refuses (backpressure) is sent again at each later turn, in order,
    until admitted: its latency still runs from its due time. Returns per
    request its send and completion times (s after the window opened;
    NaN: never), whether it was refused at least once, and the answers of
    the requests in ``keep``."""
    from repro_torch.reach import Rejected
    due, blk = win.due, win.block
    n_req = due.size
    sent = np.full(n_req, np.nan)
    done = np.full(n_req, np.nan)
    refused = np.zeros(n_req, dtype=bool)
    got, ticket_of, retry = {}, {}, []
    i = 0
    t0 = clock()

    def send(j) -> bool:
        with spans("online.submit"):
            try:
                tk = fe.submit(_tenant(int(win.tenant[j])),
                               win.s[j * blk:(j + 1) * blk],
                               win.t[j * blk:(j + 1) * blk])
            except Rejected:
                refused[j] = True
                return False
        ticket_of[tk] = j
        sent[j] = clock() - t0
        return True

    def collect(now):
        for tk, ans in fe.results().items():
            j = ticket_of.pop(tk)
            done[j] = now
            if j in keep:
                got[j] = ans

    while True:
        now = clock() - t0
        retry = [j for j in retry if not send(j)]
        while i < n_req and due[i] <= now:
            if not send(i):
                retry.append(i)
            i += 1
        collect(clock() - t0)
        closed = i >= n_req
        next_due = due[i] if not closed else math.inf
        if not (fe.router.pending_queries or fe.busy or retry):
            if closed:
                break
            _wait_until(clock, t0, next_due, spans)
            continue
        if closed and now > seconds + DRAIN_S:
            break
        if not fe.busy and not closed and not retry:
            # nothing in flight: the frontend cuts a slab when its oldest
            # request is due to flush, so wait for that or the next arrival
            flush_at = fe.next_deadline() - t0
            if flush_at > now:
                _wait_until(clock, t0, min(flush_at, next_due), spans)
                continue
        with spans("online.poll"):
            fe.poll(force=closed)
        collect(clock() - t0)
    return sent, done, refused, got


def _wait_until(clock, t0: float, at: float, spans) -> None:
    with spans("online.wait"):
        while True:
            left = at - (clock() - t0)
            if left <= 0:
                return
            if left > 2e-3:
                time.sleep(left - 1e-3)


def check(win, answers: list, rows: list, graph, device) -> dict:
    """Every answer the program gave for a sampled pair against the plain
    reference. ``rows[i]``: the positions in ``win`` of ``answers[i]``."""
    n, src, dst = graph
    pos = np.unique(np.concatenate(rows)) if rows else np.zeros(0, np.int64)
    want = reference.reach_answers(n, src, dst, win.s[pos], win.t[pos],
                                   device=device)
    bad = 0
    for ans, at in zip(answers, rows):
        bad += int((ans != want[np.searchsorted(pos, at)]).sum())
    return {"pairs": int(pos.size), "answers": int(sum(r.size for r in rows)),
            "positive": int(want.sum()), "mismatches": bad}


def sampled_rows(win, mix: dict, seed: int):
    """The blocks the check compares, and their rows in ``win``."""
    blocks = traffic.sample_blocks(win, mix, seed)
    return blocks, (blocks[:, None] * win.block
                    + np.arange(win.block)).ravel()


def run_cell(m: "manifest.Manifest", cell_name: str, seed: int,
             seconds: float, trace: bool, device: str, clock0: float,
             cfg: dict = None, mix: dict = None) -> dict:
    """One run; returns the result line's fields and the compared numbers
    (``compared``), without the ``sys.modules`` look."""
    import torch
    from repro_torch.kernels import _lib, frontier_fused
    from repro_torch.reach import Frontend
    dev = torch.device(device)
    cell = m.cell(cell_name)
    cfg = cfg if cfg is not None else m.config(cell)
    mix = mix if mix is not None else m.traffic(cell)
    spans = Spans()
    clock = time.perf_counter
    gseed = int(seed) % (1 << 63)
    sess, graph, _, win, host = setup(cfg, mix, gseed, seconds, dev, spans)
    frontier_fused.STEPS.reset()
    launched = dict(_lib.LAUNCHES)
    blocks, sample = sampled_rows(win, mix, gseed)
    if mix["loop"] == "closed":
        q = int(mix["pairs_per_call"])
        in_call = [sample[(sample >= c * q) & (sample < (c + 1) * q)] - c * q
                   for c in range(win.s.size // q)]
    ctx = {"cell": cell, "config": cfg, "mix": mix, "host": host,
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else dev.type)}
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        spans.on = True
    host["setup_s"] = clock() - clock0
    fe = None
    with spans("window"):
        if mix["loop"] == "closed":
            calls, answers, elapsed = closed_loop(sess, win, mix, seconds,
                                                  spans, clock, in_call)
        else:
            fe = Frontend(sess)
            keep = set(int(b) for b in blocks)
            sent, done, refused, got = open_loop(fe, win, seconds, spans,
                                                 clock, keep)
        _sync(dev)
    if prof is not None:
        prof.stop()
        spans.on = False
    host["window_s"] = seconds if fe is not None else elapsed
    # the answers compared: each served call's sampled rows, or each
    # sampled request that was answered
    if fe is None:
        rows = [in_call[c] + c * q for c in calls]
        host["pairs"] = len(calls) * q
        attempted, failed, unanswered = len(calls) * q, 0, 0
        ctx.update(traffic=win, calls=calls)
    else:
        rows = [np.arange(b * win.block, (b + 1) * win.block)
                for b in sorted(got)]
        answers = [got[b] for b in sorted(got)]
        lost = np.isnan(done)
        latency = np.where(lost, np.inf, done - win.due)
        late = np.where(np.isnan(sent), np.inf, sent - win.due)
        host.update(latency_s=latency, late_s=late,
                    requests=int(win.due.size), pairs=int(win.s.size),
                    refused=int(refused.sum()),
                    **{f"p{q}_ms": percentile(latency, q) * 1e3
                       for q in (50, 90, 95, 99, 99.9, 100)})
        if "slo_ms" in mix:
            host["on_time_pct"] = float(
                np.mean(latency <= mix["slo_ms"] / 1e3) * 100)
        attempted, failed = int(win.due.size), int(lost.sum())
        unanswered = int(lost[blocks].sum())
        ctx["frontend"] = fe.stats.as_dict()
    ctx["session"] = sess.stats.as_dict()
    ctx["steps"] = dict(frontier_fused.STEPS)
    ctx["launches"] = {k: v - launched.get(k, 0)
                       for k, v in _lib.LAUNCHES.items()}
    if prof is not None:
        ctx["trace"] = devtrace.summarize(devtrace.events(prof))
        del prof
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    del fe, sess
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = clock()
    checked = check(win, answers, rows, graph, dev)
    check_s = clock() - t0
    correct = checked["mismatches"] == 0 and unanswered == 0
    metrics = {}
    for entry in m.metrics(cell, trace):
        value = m.reader(entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": ctx["device_kind"],
        "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if "trace" in ctx:
        device_info["busy_s"] = ctx["trace"]["busy_s"]
        device_info["window_s"] = ctx["trace"]["window_s"]
        out["breakdown"] = ctx["trace"]["breakdown"]
    out["compared"] = {
        "mismatches": {"value": checked["mismatches"], "limit": 0,
                       "of": checked["answers"]},
        "unanswered": {"value": unanswered, "limit": 0}}
    out["_checked"] = checked
    out["_host"] = {k: v for k, v in host.items()
                    if isinstance(v, (int, float))}
    out["_host"].update(check_s=check_s, phase2_host=ctx["session"][
        "phase2_host"], sparse_retries=ctx["session"]["sparse_retries"],
        kernel3_launches=ctx["launches"]["probe"])
    if "trace" in ctx:
        out["_host"]["kernel3_traced"] = devtrace.kernel3_traced(ctx["trace"])
    return out


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="reachbench/run.py",
        description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, clock0: float) -> int:
    args = _parse(argv)
    m = manifest.Manifest()
    cell = m.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("reachbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"reachbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run_cell(m, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda:0", clock0)
    found = forbidden_modules()
    if found:
        print(f"reachbench: the run loaded {found}", file=sys.stderr)
        return 3
    checked = out.pop("_checked")
    record = out.pop("_host")
    bad = [k for k, v in out["metrics"].items() if not math.isfinite(v["value"])]
    if bad:
        # a tail past the requests that were answered: more than 5% lost
        print(f"reachbench: {bad} not finite: {out['failed']} of "
              f"{out['attempted']} requests never answered",
              file=sys.stderr)
        return 4
    print(f"reachbench: {args.workload} seed {args.seed}: {checked['pairs']} "
          f"sampled pairs ({checked['positive']} reachable), "
          f"{checked['answers']} answers compared; "
          + ", ".join(f"{k} {v:.6g}" for k, v in record.items()),
          file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
