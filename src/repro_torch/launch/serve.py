"""Reachability serving driver of the PyTorch/CUDA port.

Builds a FERRARI index over a synthetic scale-free graph on the host, then
serves a query stream through ``repro_torch.reach.QuerySession`` on one
device: phase 1 and the sparse phase 2 run the CUDA kernels on a card.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode reachability \\
        --nodes 20000 --queries 100000 --k 2 --device cuda

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""
from __future__ import annotations

import argparse
import time

from ..core.packed import pack_index
from ..core.workload import positive_queries, random_queries
from ..graphs.generators import scale_free_digraph
from ..reach import IndexSpec, QuerySession, build


def serve_reachability(n_nodes: int, avg_deg: float, n_queries: int,
                       spec: IndexSpec, *, seed: int = 0,
                       workload: str = "random", device="cuda") -> dict:
    """Build, warm up, then serve ``n_queries`` of ``workload`` once,
    timed. Returns the wall time, ns/query, positives and SessionStats."""
    print(f"building graph n={n_nodes} avg_deg={avg_deg} ...", flush=True)
    g = scale_free_digraph(n_nodes, avg_deg, seed=seed)
    t0 = time.perf_counter()
    ix = build(g, spec)
    # pack once and share the ELL layout with the session (both are O(n)
    # host loops); it is built only when phase 2 resolves to sparse
    pk = pack_index(ix)
    t_build = time.perf_counter() - t0
    print(f"index built in {t_build:.2f}s: {ix.stats.n_comp} SCCs, "
          f"{ix.stats.total_intervals} intervals "
          f"({ix.byte_size() / 2**20:.1f} MiB)", flush=True)
    p2 = spec.phase2_mode
    if p2 == "auto":
        p2 = "dense" if pk.n <= spec.n_dense_max else "sparse"
    ell = pk.ell_layout(width=spec.ell_width) if p2 == "sparse" else None
    sess = QuerySession(ix, spec, packed=pk, ell=ell, device=device)
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
            "trace_count": sess.trace_count, "spec": spec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["reachability"],
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
    IndexSpec.add_cli_args(ap)       # --k --variant --phase2 --max-batch ...
    args = ap.parse_args(argv)
    # clamp before construction: IndexSpec validates max_batch >= min_bucket
    args.min_bucket = min(args.min_bucket, args.max_batch)
    return serve_reachability(args.nodes, args.avg_deg, args.queries,
                              IndexSpec.from_args(args), seed=args.seed,
                              workload=args.workload, device=args.device)


if __name__ == "__main__":
    main()
