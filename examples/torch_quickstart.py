"""Quickstart on the PyTorch/CUDA port: build a FERRARI index, persist it,
and serve queries through the ``repro_torch.reach`` facade.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On a card (the default) phase 1 runs kernel 1 and the sparse phase 2
kernels 3 and 4; ``--device cpu`` runs their plain PyTorch versions.
"""
import argparse
import tempfile

import numpy as np

from repro_torch import reach
from repro_torch.core import intervals as iv
from repro_torch.core.ferrari import build_index
from repro_torch.core.query import QueryEngine
from repro_torch.graphs.generators import scale_free_digraph, small_example_graph


def paper_example():
    print("=== paper Figure 1 example graph ===")
    g = small_example_graph()
    ix = build_index(g, k=2, variant="L", use_seeds=False)
    names = "abcdefg"
    for v in range(g.n):
        c = ix.cond.comp[v]
        print(f"  node {names[v]}: pi={ix.tl.pi[c]:2d} "
              f"I'={iv.to_tuples(ix.labels[c])}")
    eng = QueryEngine(ix)
    for s, t in [(0, 4), (1, 4), (4, 0), (6, 5), (0, 5)]:
        print(f"  {names[s]} ~> {names[t]} ? {eng.reachable(s, t)}")


def facade_demo(n: int, n_queries: int, device: str):
    print(f"\n=== {n}-node web-like graph: build -> save -> load -> serve "
          f"on {device} ===")
    g = scale_free_digraph(n, 4.0, seed=0)
    spec = reach.IndexSpec(k=2, variant="G")     # the one knob object
    ix = reach.build(g, spec)
    print(f"  condensed: {ix.stats.n_comp} SCC nodes, "
          f"{ix.stats.total_intervals} intervals, "
          f"{ix.byte_size() / 2**20:.1f} MiB, "
          f"built in {ix.stats.seconds_total:.2f}s")
    with tempfile.TemporaryDirectory() as d:
        reach.save_index(d, ix, spec)            # npz artifact + manifest
        sess = reach.QuerySession.load(d, device=device)
        rng = np.random.default_rng(1)
        qs = rng.integers(0, g.n, n_queries)
        qt = rng.integers(0, g.n, n_queries)
        ans = sess.query(qs, qt)                 # bucketed micro-batches
        print(f"  {n_queries} queries -> {int(ans.sum())} positive; "
              f"{sess.trace_count} phase-1 batch shapes")
        # queued serving: small requests coalesce into full micro-batches
        tickets = [sess.submit(qs[i::10], qt[i::10]) for i in range(10)]
        results = sess.drain()
        assert all(t in results for t in tickets)
        print(f"  phase stats: {sess.stats}")
    return ans


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args()
    paper_example()
    facade_demo(args.nodes, args.queries, args.device)
