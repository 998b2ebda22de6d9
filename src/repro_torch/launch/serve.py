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
saves one (first run builds, reruns load). ``--device cpu`` runs the
kernels' plain PyTorch versions instead.

``--mode lm`` prefills random prompts, then decodes greedily, with random
weights from ``--seed``: on a card at the arch's published widths, on the
CPU at its SMOKE config (as the reference's ``serve_lm``; the SMOKE head
dims 16 and 32 are below the flash kernel's 64):

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch tinyllama-1.1b --batch 2 --prompt-len 512 --gen-len 16
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from pathlib import Path

import torch

from ..configs import get_config, get_smoke
from ..core.packed import pack_index
from ..core.query_torch import resolve_device
from ..core.workload import positive_queries, random_queries
from ..graphs.generators import scale_free_digraph
from ..models import transformer as tf
from ..reach import (IndexSpec, QuerySession, build, load_manifest,
                     save_index)
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
                       index_dir=None) -> dict:
    """Build (or load from ``index_dir``), warm up, then serve
    ``n_queries`` of ``workload`` once, timed. Returns the wall time,
    ns/query, positives and SessionStats."""
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
    return {"seconds": dt, "ns_per_query": dt / n_queries * 1e9,
            "positive": pos, "stats": stats, "build_seconds": t_build,
            "trace_count": sess.trace_count, "spec": spec,
            "loaded": loaded}


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
        p2 = "dense" if pk.n <= spec.n_dense_max else "sparse"
    ell = (pk.ell_layout(width=spec.ell_width)
           if index_dir is not None or p2 == "sparse" else None)
    sess = QuerySession(ix, spec, packed=pk, ell=ell, device=device)
    if index_dir is not None:
        save_index(index_dir, ix, spec, meta={"graph": graph_meta},
                   packed=pk, ell=ell)
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
    (the first tokens on the host) and ``decode_s`` (every decode step,
    each ending with its tokens on the host)."""
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
    for i in range(gen_len - 1):
        logits, cache = tf.decode_step(cfg, params, cache, cur, S + i)
        cur = logits.argmax(-1, keepdim=True).to(torch.int32)
        out.append(cur.cpu())
    t_decode = time.perf_counter() - t0 - t_first
    return {"tokens": torch.cat(out, dim=1), "prefill_s": t_prefill,
            "ttft_s": t_first, "decode_s": t_decode,
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
    total = res["ttft_s"] + res["decode_s"]
    print(f"{cfg.arch_id} ({config}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) on {dev}: served {batch} requests x "
          f"{gen_len} tokens in {total:.2f}s ({batch * gen_len / total:.0f} "
          f"tok/s); prefill of {prompt_len} tokens {res['prefill_s']:.3f}s, "
          f"first token {res['ttft_s']:.3f}s, "
          f"{res['decode_s'] / max(steps, 1) * 1e3:.2f} ms per decode step")
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
    return serve_reachability(args.nodes, args.avg_deg, args.queries,
                              IndexSpec.from_args(args), seed=args.seed,
                              workload=args.workload, device=args.device,
                              index_dir=args.index_dir)


if __name__ == "__main__":
    main()
