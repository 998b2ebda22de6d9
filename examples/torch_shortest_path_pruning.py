"""Search-space pruning with FERRARI on the PyTorch/CUDA port — the
paper's §1 motivating use.

"Dijkstra's algorithm can be greatly sped up by avoiding the expansion of
vertices that cannot reach the target node." This example runs Dijkstra on
a weighted directed graph twice — plain, and pruned by a FERRARI
reachability oracle — and reports the expansion reduction and that both
find identical distances. The oracle is one batch on the device a target:
``QuerySession.query`` of every node against t, answered by kernel 1 and
the sparse phase 2 on a card.

    PYTHONPATH=src python examples/torch_shortest_path_pruning.py [--device cpu]
"""
import argparse
import heapq
import time

import numpy as np

from repro_torch import reach
from repro_torch.graphs.generators import scale_free_digraph


def dijkstra(indptr, indices, weights, s, t, can_reach=None):
    n = len(indptr) - 1
    dist = np.full(n, np.inf)
    dist[s] = 0.0
    pq = [(0.0, s)]
    expanded = 0
    while pq:
        d, v = heapq.heappop(pq)
        if v == t:
            return d, expanded
        if d > dist[v]:
            continue
        expanded += 1
        for e in range(indptr[v], indptr[v + 1]):
            w = indices[e]
            # the paper's pruning rule: never expand toward nodes that
            # cannot reach the target
            if can_reach is not None and not can_reach[w]:
                continue
            nd = d + weights[e]
            if nd < dist[w]:
                dist[w] = nd
                heapq.heappush(pq, (nd, w))
    return np.inf, expanded


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    n = args.nodes
    g = scale_free_digraph(n, 3.0, seed=3, back_p=0.2)
    rng = np.random.default_rng(0)
    weights = rng.uniform(1.0, 10.0, g.m)

    print(f"graph: {g.n} nodes, {g.m} edges — building FERRARI-G (k=2)...")
    spec = reach.IndexSpec(k=2, variant="G")
    sess = reach.QuerySession(reach.build(g, spec), spec, device=args.device)
    nodes = np.arange(n)

    tot_plain = tot_pruned = 0
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        s, t = (int(x) for x in rng.integers(0, n, 2))
        # one device batch: which nodes can reach t
        can_reach = sess.query(nodes, np.full(n, t))
        d0, e0 = dijkstra(g.indptr, g.indices, weights, s, t)
        d1, e1 = dijkstra(g.indptr, g.indices, weights, s, t,
                          can_reach=can_reach)
        assert (np.isinf(d0) and np.isinf(d1)) or abs(d0 - d1) < 1e-9, \
            (d0, d1)
        tot_plain += e0
        tot_pruned += e1
    dt = time.perf_counter() - t0
    print(f"{args.pairs} (s, t) pairs in {dt:.1f}s on {sess.engine.device}")
    print(f"expanded nodes: plain {tot_plain}, pruned {tot_pruned} "
          f"({tot_plain / max(tot_pruned, 1):.1f}x fewer) — identical "
          f"distances")
    print(f"oracle stats: {sess.stats}")
    return {"plain": tot_plain, "pruned": tot_pruned}


if __name__ == "__main__":
    main()
