"""Serving command line of the PyTorch/CUDA port: reachability, and
greedy LM generation.

Builds a FERRARI index over a synthetic scale-free graph — on the host
(``--builder host``) or on the device (``--builder wavefront
--cover-method topgap``, kernel 5 on a card) — or loads a saved one, then
serves a query stream through ``repro_torch.reach.QuerySession`` on one
device: phase 1 and the sparse phase 2 run the CUDA kernels on a card.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode reachability \
        --nodes 20000 --queries 100000 --k 2 --device cuda

``--index-dir DIR`` loads the artifact committed there, or builds and
saves one (first run builds, reruns load). ``--updates N`` then streams N
random edge inserts through the live session in ``--update-batch``
batches, each followed by a query batch over the mutated graph (logged to
the artifact and replayed on the next load when ``--index-dir`` is set).
``--device cpu`` runs the kernels' plain PyTorch versions instead.

``--placement replicated|sharded`` (with ``--mesh DATAxMODEL``) serves
from every rank of a process group, one process a device, started by
``torchrun`` (which sets the rank, the world and the rendezvous); the
command then initialises the group from that environment (NCCL on the
cards, one card a rank by ``LOCAL_RANK``; gloo with ``--device cpu``),
and only rank 0 prints:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --nodes 200000 --queries 100000 --placement sharded --mesh 2x2
 ``--tenants N`` re-serves the
stream through the async frontend (``reach.frontend``) in
``--request-size`` requests over N tenants and prints its ``frontend:``
block; ``--metrics-dump`` writes the telemetry registry's snapshot and
``--trace-out`` a Chrome trace of the run's spans (host time: a span
around a kernel launch covers the launch, not the kernel).

``--mode lm`` prefills random prompts, then decodes greedily, with random
weights from ``--seed``: on a card at the arch's published widths, on the
CPU at its SMOKE config (as the reference's ``serve_lm``; the SMOKE head
dims 16 and 32 are below the flash kernel's 64). The MoE archs decode
from an int8 cache (``generate``):

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch moonshot-v1-16b-a3b --batch 1 --prompt-len 4096 --gen-len 32
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..configs import get_config, get_smoke
from ..core.packed import pack_index
from ..core.query_torch import resolve_device
from ..core.workload import (positive_queries, random_edge_inserts,
                             random_queries)
from ..graphs.generators import scale_free_digraph
from ..models import transformer as tf
from ..reach import (Frontend, IndexSpec, QuerySession, Rejected, build,
                     load_manifest, save_index)
from ..reach.spec import BUILD_FIELDS


def _load_session(index_dir, spec: IndexSpec, graph_meta: dict, n: int,
                  device) -> QuerySession:
    """A session on the artifact under ``index_dir``. Build knobs come
    from the artifact's manifest (they are baked into it); the serve-time
    knobs of ``spec`` still apply, and ``ell_width`` adopts the saved
    value when ``spec`` leaves it None, so the saved ELL layout is reused.
    An artifact built over another graph is refused."""
    saved = load_manifest(index_dir)["extra"].get("spec")
    if saved is not None:
        saved_spec = IndexSpec.from_dict(saved)
        merged = {f: getattr(saved_spec, f) for f in BUILD_FIELDS}
        if spec.ell_width is None:
            merged["ell_width"] = saved_spec.ell_width
        dropped = {f: (getattr(spec, f), v) for f, v in merged.items()
                   if getattr(spec, f) != v}
        if dropped:
            print("note: taking build knobs from the artifact: "
                  + ", ".join(f"{f}: {cli!r} -> {art!r}"
                              for f, (cli, art) in dropped.items()),
                  flush=True)
        spec = replace(spec, **merged)
    sess = QuerySession.load(index_dir, spec, device=device)
    # an index answers only for the graph it was built over
    saved_graph = sess.artifact_manifest["extra"].get(
        "user_meta", {}).get("graph")
    if saved_graph is not None and saved_graph != graph_meta:
        raise ValueError(
            f"index artifact at {index_dir} was built over {saved_graph}, "
            f"not {graph_meta}; rebuild it or point --index-dir elsewhere")
    if sess.index.cond.comp.shape[0] != n:
        raise ValueError(
            f"index artifact at {index_dir} covers "
            f"{sess.index.cond.comp.shape[0]} nodes, graph has {n}")
    return sess


def serve_reachability(n_nodes: int, avg_deg: float, n_queries: int,
                       spec: IndexSpec, *, seed: int = 0,
                       workload: str = "random", device="cuda",
                       index_dir=None, n_updates: int = 0,
                       update_batch: int = 256, n_tenants: int = 0,
                       request_size: int = 64,
                       metrics_dump: str | None = None,
                       trace_out: str | None = None) -> dict:
    """Build (or load from ``index_dir``), warm up, then serve
    ``n_queries`` of ``workload`` once, timed. Returns the wall time,
    ns/query, positives and SessionStats.

    ``n_updates > 0`` then streams that many random edge inserts through
    the live session in ``update_batch`` batches, each followed by the
    next ``spec.max_batch`` queries of the stream over the mutated graph
    (inserts oriented by the condensed topological order, so compactions
    stay incremental); its stats come back as ``update_stats``.

    ``n_tenants > 0`` re-serves the stream through the async frontend:
    chopped into ``request_size``-pair requests spread round-robin over
    the tenants, pushed through the deadline-aware coalescing loop (a
    ``queue_full`` rejection polls the loop instead of growing a queue);
    its FrontendStats are printed and returned. ``metrics_dump``: write
    the metrics registry's snapshot (and the frontend's slow-slab log)
    there as JSON; ``trace_out``: record spans from the start and write
    them there as a Chrome trace."""
    if trace_out is not None:
        # spans record from here on: build stages, every slab's lifecycle,
        # phase-1/phase-2 splits — exported Perfetto-loadable at the end
        obs.enable_tracing()
    print(f"building graph n={n_nodes} avg_deg={avg_deg} ...", flush=True)
    g = scale_free_digraph(n_nodes, avg_deg, seed=seed)
    graph_meta = {"generator": "scale_free_digraph", "n_nodes": n_nodes,
                  "avg_deg": avg_deg, "seed": seed}
    t0 = time.perf_counter()
    loaded = index_dir is not None and any(Path(index_dir).glob(
        "step_*.done"))
    if loaded:
        sess = _load_session(index_dir, spec, graph_meta, g.n, device)
        spec = sess.spec
        t_build = time.perf_counter() - t0
        print(f"index loaded from {index_dir} in {t_build:.2f}s", flush=True)
    else:
        sess, t_build = _build_session(g, spec, device, index_dir,
                                       graph_meta)
    if spec.placement != "single":
        mesh = sess.engine.mesh
        print(f"placement: {spec.placement} over mesh "
              f"{{'data': {mesh.n_data}, 'model': {mesh.n_model}}} "
              f"({mesh.world} devices, {dist.get_backend()})", flush=True)
    print(f"device: {sess.engine.device}; phase-2 engine: "
          f"{sess.engine.phase2_mode}", flush=True)
    qs, qt = (random_queries if workload == "random"
              else positive_queries)(g, n_queries, seed=seed + 1)
    batch = spec.max_batch
    # warmup: a real first batch runs phase 1 and the phase-2 path it
    # needs (the kernels build here on first use); then the tail bucket
    first = min(batch, n_queries)
    sess.query(qs[:first], qt[:first])
    sess.warmup(n_queries % batch)
    t0 = time.perf_counter()
    ans = sess.query(qs, qt)
    dt = time.perf_counter() - t0
    pos = int(ans.sum())
    stats = sess.stats
    print(f"{n_queries} {workload} queries in {dt * 1e3:.1f} ms "
          f"({dt / n_queries * 1e9:.0f} ns/query), {pos} positive, "
          f"{sess.trace_count} phase-1 batch shapes")
    print(f"phase stats: {stats}")
    fe = None
    if n_tenants > 0:
        fe = _serve_frontend(sess, spec, qs, qt, n_tenants, request_size)
    update_stats = None
    if n_updates > 0:
        update_stats = _serve_updates(sess, spec, g.n, qs, qt, n_updates,
                                      update_batch, seed)
    if metrics_dump is not None:
        snap = obs.metrics_snapshot()
        if fe is not None:
            snap["slowlog"] = fe.slowlog.as_dict()
        with open(metrics_dump, "w") as f:
            json.dump(snap, f, indent=2, default=str)
        print(f"metrics snapshot written to {metrics_dump}", flush=True)
    if trace_out is not None:
        tr = obs.get_tracer()
        obs.export_chrome_trace(trace_out)
        print(f"trace written to {trace_out} "
              f"({len(tr.events())} spans, {tr.n_dropped} dropped; host "
              "time) — load it at https://ui.perfetto.dev", flush=True)
    return {"seconds": dt, "ns_per_query": dt / n_queries * 1e9,
            "positive": pos, "stats": stats, "build_seconds": t_build,
            "trace_count": sess.trace_count, "spec": spec,
            "loaded": loaded, "update_stats": update_stats,
            "frontend_stats": None if fe is None else fe.stats}


def _serve_updates(sess, spec: IndexSpec, n: int, qs, qt, n_updates: int,
                   update_batch: int, seed: int):
    """The live-graph churn loop: insert a batch, then answer a query
    slice against the mutated graph, with no restart and no rebuild.
    Prints the inserts' rate and the churn stats; returns the stats."""
    if sess.epoch or sess.stats.overlay_edges:
        print(f"resumed at epoch {sess.epoch} with "
              f"{sess.stats.overlay_edges} replayed overlay edges",
              flush=True)
    # the resume point is in the seed: a rerun extends the replayed graph
    # with fresh edges instead of drawing (and dropping) the last run's
    rng = np.random.default_rng(
        (seed + 2, sess.epoch, sess.stats.overlay_edges))
    sess.reset_stats()
    batch, qcur = spec.max_batch, 0
    t0 = time.perf_counter()
    for lo in range(0, n_updates, update_batch):
        b = min(update_batch, n_updates - lo)
        # by the condensed topological order: no insert closes a condensed
        # cycle, so compactions stay on the bounded incremental path
        sess.apply_updates(*random_edge_inserts(
            n, b, rng, order=sess.index.cond.comp))
        hi = min(qcur + batch, qs.size)
        if hi > qcur:
            sess.query(qs[qcur:hi], qt[qcur:hi])
            qcur = hi
    dt = time.perf_counter() - t0
    st = sess.stats
    print(f"{n_updates} edge inserts in {dt:.2f}s ({n_updates / dt:.0f} "
          f"updates/s interleaved with {qcur} queries), "
          f"{st.n_compactions} compactions, overlay fill "
          f"{st.overlay_edges}/{spec.overlay_cap}, epoch {sess.epoch}")
    print(f"churn stats: {st}")
    return st


def _serve_frontend(sess, spec: IndexSpec, qs, qt, n_tenants: int,
                    request_size: int) -> Frontend:
    """The stream through a ``Frontend`` on ``sess``, closed loop;
    prints the ``frontend:`` block and returns the frontend."""
    # a request larger than min(queue_cap, max_batch) is rejected
    # "too_large" on EVERY submit — no amount of polling makes it
    # admissible, so validate up front instead of spinning forever
    admissible = min(spec.tenant_queue_cap, spec.max_batch)
    if request_size > admissible:
        raise ValueError(
            f"--request-size {request_size} exceeds the admissible "
            f"bound min(tenant_queue_cap={spec.tenant_queue_cap}, "
            f"max_batch={spec.max_batch}) = {admissible}; shrink the "
            "request or raise --tenant-queue-cap/--max-batch")
    fe = Frontend(sess)
    backpressure = 0
    n_queries = qs.size
    t0 = time.perf_counter()
    for i, lo in enumerate(range(0, n_queries, request_size)):
        tenant = f"tenant-{i % n_tenants}"
        s, d = qs[lo:lo + request_size], qt[lo:lo + request_size]
        while True:
            try:
                fe.submit(tenant, s, d)
                break
            except Rejected as e:
                if e.reason != "queue_full":
                    raise      # permanent: polling can't fix it
                # bounded queues: drain the loop instead of growing
                backpressure += 1
                fe.poll()
    served = sum(a.size for a in fe.drain().values())
    dt_f = time.perf_counter() - t0
    st = fe.stats
    print(f"frontend: {served} queries over {n_tenants} tenants "
          f"({request_size}/request) in {dt_f * 1e3:.1f} ms "
          f"({dt_f / max(served, 1) * 1e9:.0f} ns/query), "
          f"{backpressure} backpressure stalls, "
          f"occupancy {st.occupancy:.3f}, "
          f"{st.deadline_misses} deadline misses")
    for name in sorted(st.tenants):
        t = st.tenants[name]
        # percentiles are None until a tenant completes a request
        p50 = "n/a" if t.p50_us is None else f"{t.p50_us:.0f}us"
        p99 = "n/a" if t.p99_us is None else f"{t.p99_us:.0f}us"
        print(f"  {name}: {t.completed}/{t.requests} requests "
              f"p50={p50} p99={p99} "
              f"misses={t.deadline_misses} "
              f"cache_hits={t.cache_short_circuits}")
    print(fe.slowlog.format_report())
    if st.cache is not None:
        c = st.cache
        print(f"  cache: {c['entries']}/{c['capacity']} entries, "
              f"hit_rate={c['hit_rate']:.3f}, "
              f"{c['evictions']} evictions, "
              f"{c['invalidations']} invalidations")
    return fe


def _build_session(g, spec: IndexSpec, device, index_dir, graph_meta):
    """Build the index (on ``device`` for the wavefront builder), pack it
    once for the session and the artifact, and save it to ``index_dir``
    when given. Returns (session, build seconds)."""
    t0 = time.perf_counter()
    ix = build(g, spec, device=device)
    t_build = time.perf_counter() - t0
    print(f"index built in {t_build:.2f}s ({spec.builder}): "
          f"{ix.stats.n_comp} SCCs, {ix.stats.total_intervals} intervals "
          f"({ix.byte_size() / 2**20:.1f} MiB)", flush=True)
    if spec.builder == "wavefront":
        # hub fan-in stays on the device
        print(f"wavefront build: {ix.stats.hub_nodes} hub nodes, "
              f"{ix.stats.merge_rounds} merge rounds, "
              f"{ix.stats.host_fallbacks} host fallbacks, "
              f"peak slab {ix.stats.peak_slab_bytes / 2**20:.1f} MiB",
              flush=True)
    # pack once and share between the session and the artifact (both are
    # O(n) host loops); the ELL layout is built only when something uses
    # it: a saved artifact, or a sparse phase 2
    pk = pack_index(ix)
    p2 = spec.phase2_mode
    if p2 == "auto":
        p2 = ("sparse" if spec.placement != "single"
              else "dense" if pk.n <= spec.n_dense_max else "sparse")
    ell = (pk.ell_layout(width=spec.ell_width)
           if index_dir is not None or p2 == "sparse" else None)
    sess = QuerySession(ix, spec, packed=pk, ell=ell, device=device)
    if index_dir is not None:
        if spec.placement == "single" or dist.get_rank() == 0:
            save_index(index_dir, ix, spec, meta={"graph": graph_meta},
                       packed=pk, ell=ell)
        if spec.placement != "single":
            dist.barrier()          # saved before any rank logs to it
        sess.bind_artifact(index_dir)     # updates log, replay on rerun
        print(f"index saved to {index_dir}", flush=True)
    return sess, time.perf_counter() - t0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, tokens, gen_len: int) -> dict:
    """Greedy generation: prefill ``tokens [B, S]`` into a cache of S +
    gen_len positions, take the first token from the prefill's logits,
    then run ``gen_len - 1`` decode steps. Returns the tokens [B, gen_len]
    and the wall times: ``prefill_s`` (ends in a device sync), ``ttft_s``
    (the first tokens on the host), ``quantize_s`` and ``decode_s`` (every
    decode step, each ending with its tokens on the host).

    With ``cfg.kv_cache_dtype == "int8"`` the prefill's cache, in the
    model's dtype, is re-encoded by ``quantize_cache`` after the first
    token (``quantize_s``, ending in a device sync) and the decode steps
    read the int8 cache: the reference's own int8 decode path, which its
    ``serve_lm`` lacks (it would stop at the missing scales)."""
    B, S = tokens.shape
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tf.prefill(cfg, params, tokens, S + gen_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    cur = logits.argmax(-1, keepdim=True).to(torch.int32)
    out = [cur.cpu()]
    t_first = time.perf_counter() - t0
    t_quant = 0.0
    if cfg.kv_cache_dtype == "int8":
        cache = tf.quantize_cache(cache)
        _sync(dev)
        t_quant = time.perf_counter() - t0 - t_first
    for i in range(gen_len - 1):
        logits, cache = tf.decode_step(cfg, params, cache, cur, S + i)
        cur = logits.argmax(-1, keepdim=True).to(torch.int32)
        out.append(cur.cpu())
    t_decode = time.perf_counter() - t0 - t_first - t_quant
    return {"tokens": torch.cat(out, dim=1), "prefill_s": t_prefill,
            "ttft_s": t_first, "quantize_s": t_quant, "decode_s": t_decode,
            "decode_steps": gen_len - 1}


def serve_lm(arch: str, batch: int, prompt_len: int, gen_len: int, *,
             seed: int = 0, device="cuda") -> dict:
    """Random weights and prompts from ``seed`` on ``device`` (the
    published config on a card, SMOKE on the CPU), then ``generate``;
    prints and returns its result."""
    dev = resolve_device(device)
    config = "full" if dev.type == "cuda" else "smoke"
    cfg = (get_config if dev.type == "cuda" else get_smoke)(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = tf.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=dev, dtype=torch.int32)
    res = generate(cfg, params, toks, gen_len)
    steps = res["decode_steps"]
    total = res["ttft_s"] + res["quantize_s"] + res["decode_s"]
    print(f"{cfg.arch_id} ({config}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) on {dev}: served {batch} requests x "
          f"{gen_len} tokens in {total:.2f}s ({batch * gen_len / total:.0f} "
          f"tok/s); prefill of {prompt_len} tokens {res['prefill_s']:.3f}s, "
          f"first token {res['ttft_s']:.3f}s, "
          + (f"int8 cache re-encoded in {res['quantize_s']:.3f}s, "
             if cfg.kv_cache_dtype == "int8" else "")
          + f"{res['decode_s'] / max(steps, 1) * 1e3:.2f} ms per decode step")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["reachability", "lm"],
                    default="reachability")
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--avg-deg", type=float, default=4.0)
    ap.add_argument("--queries", type=int, default=100_000)
    ap.add_argument("--workload", default="random",
                    choices=["random", "positive"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    ap.add_argument("--index-dir", default=None,
                    help="load the index artifact committed here, or "
                         "build and save one")
    ap.add_argument("--updates", type=int, default=0,
                    help="stream this many random edge inserts through the "
                         "live session, interleaved with query batches "
                         "(logged and replayed when --index-dir is set)")
    ap.add_argument("--update-batch", type=int, default=256,
                    help="edge inserts per apply_updates() batch")
    ap.add_argument("--tenants", type=int, default=0,
                    help="also serve the stream through the async "
                         "frontend spread over this many tenants "
                         "(0 = skip)")
    ap.add_argument("--request-size", type=int, default=64,
                    help="query pairs per frontend request")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the obs metrics-registry snapshot (JSON: "
                         "all counters/histograms/stat views + the "
                         "frontend slow-slab log) here on exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable trace spans and write a Chrome "
                         "trace-event JSON here on exit (load at "
                         "ui.perfetto.dev)")
    IndexSpec.add_cli_args(ap)       # --k --variant --phase2 --max-batch ...
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4,
                    help="lm mode: decode batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    args = ap.parse_args(argv)
    if args.mode == "lm":
        return serve_lm(args.arch, args.batch, args.prompt_len, args.gen_len,
                        seed=args.seed, device=args.device)
    # clamp before construction: IndexSpec validates max_batch >= min_bucket
    args.min_bucket = min(args.min_bucket, args.max_batch)
    spec = IndexSpec.from_args(args)
    quiet = contextlib.nullcontext()
    if spec.placement != "single":
        quiet = _init_process_group(args.device)
    with quiet:
        return serve_reachability(args.nodes, args.avg_deg, args.queries,
                                  spec, seed=args.seed,
                                  workload=args.workload, device=args.device,
                                  index_dir=args.index_dir,
                                  n_updates=args.updates,
                                  update_batch=args.update_batch,
                                  n_tenants=args.tenants,
                                  request_size=args.request_size,
                                  metrics_dump=args.metrics_dump,
                                  trace_out=args.trace_out)


def _init_process_group(device):
    """The process group of a multi-device run from the launcher's
    environment (``torchrun``: RANK, WORLD_SIZE, MASTER_ADDR/PORT), unless
    the caller initialised one: NCCL with this rank's card current on a
    card, gloo on the CPU. Returns a context that keeps every rank but 0
    quiet."""
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                "--placement replicated/sharded serves from a process "
                "group: start the command under torchrun "
                "(--nproc-per-node N)")
        on_card = torch.device(device).type == "cuda"
        if on_card:
            # "cuda" names the rank's card from here on
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group("nccl" if on_card else "gloo")
    if dist.get_rank() == 0:
        return contextlib.nullcontext()
    return contextlib.redirect_stdout(open(os.devnull, "w"))


if __name__ == "__main__":
    main()
