"""Graph data pipeline: dataset synthesis, minibatch sampling, reachability
query workloads (the paper's serving data path), over the port's modules.

``synthetic_dataset``, ``NeighborSampler`` and ``query_workload`` are
numpy and give the reference's arrays. ``ReachabilityService`` is FERRARI
as a first-class framework feature: GNN training and analytics code asks
it reachability questions (negative-pair filtering, search-space pruning)
without caring that a size-constrained index answers them. It answers
through the port's ``DeviceQueryEngine`` (kernel 1, and kernels 3 and 4
wherever phase 2 runs) or the host ``QueryEngine``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core.ferrari import FerrariIndex, build_index
from ..core.query import QueryEngine
from ..core.workload import positive_queries, random_queries
from ..graphs.csr import CSR
from ..graphs.generators import layered_dag, scale_free_digraph


def synthetic_dataset(name: str, seed: int = 0):
    """Scaled-down structural analogues of the GNN benchmark datasets."""
    if name == "cora":           # small citation graph
        g = layered_dag(2_708, 30, 3.9, seed=seed)
        d_feat, n_classes = 1_433, 7
    elif name == "reddit":       # big social graph (scaled 10x down)
        g = scale_free_digraph(23_296, 24.0, seed=seed)
        d_feat, n_classes = 602, 41
    elif name == "products":     # co-purchase graph (scaled 10x down)
        g = scale_free_digraph(244_902, 12.0, seed=seed)
        d_feat, n_classes = 100, 47
    else:
        raise KeyError(name)
    rng = np.random.default_rng(seed + 1)
    feats = rng.standard_normal((g.n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, g.n).astype(np.int32)
    return g, feats, labels, n_classes


@dataclass
class NeighborSampler:
    """Fanout neighbor sampler (GraphSAGE minibatch regime). Produces a
    merged subgraph (GraphSAINT-style): node list + edge list with LOCAL
    indices, target nodes first."""
    g: CSR
    fanout: Tuple[int, ...]
    seed: int = 0

    def sample(self, batch_nodes: np.ndarray, step: int = 0):
        rng = np.random.default_rng(self.seed * 7_919 + step)
        indptr, indices = self.g.indptr, self.g.indices
        local = {int(v): i for i, v in enumerate(batch_nodes)}
        nodes = list(batch_nodes)
        src_l, dst_l = [], []
        frontier = list(batch_nodes)
        for f in self.fanout:
            nxt = []
            for v in frontier:
                v = int(v)
                lo, hi = int(indptr[v]), int(indptr[v + 1])
                if hi == lo:
                    continue
                picks = rng.integers(lo, hi, size=min(f, hi - lo))
                for e in picks:
                    w = int(indices[e])
                    if w not in local:
                        local[w] = len(nodes)
                        nodes.append(w)
                        nxt.append(w)
                    # edge w -> v (message flows neighbor -> target)
                    src_l.append(local[w])
                    dst_l.append(local[v])
            frontier = nxt
        return (np.asarray(nodes, dtype=np.int64),
                np.asarray(src_l, dtype=np.int32),
                np.asarray(dst_l, dtype=np.int32))


class ReachabilityService:
    """FERRARI behind a feature-flag interface (DESIGN.md §4).

    ``device``: True answers on the card (``"cuda"``), False on the host
    ``QueryEngine`` alone, as in the reference; a device name such as
    ``"cpu"`` runs the device engine there (the kernels' plain
    versions)."""

    def __init__(self, g: CSR, k: int = 2, variant: str = "G",
                 device=True):
        self.index: FerrariIndex = build_index(g, k=k, variant=variant)
        if device is True:
            device = "cuda"
        self.engine = None
        if device is not False:
            from ..core.query_torch import DeviceQueryEngine
            self.engine = DeviceQueryEngine(self.index, device=device)
        self.host = QueryEngine(self.index)

    def reachable(self, srcs, dsts) -> np.ndarray:
        if self.engine is not None:
            return self.engine.answer(np.asarray(srcs), np.asarray(dsts))
        return self.host.batch(srcs, dsts)

    def filter_unreachable_pairs(self, srcs, dsts):
        """Negative-sampling helper: keep only truly unreachable pairs."""
        r = self.reachable(srcs, dsts)
        return np.asarray(srcs)[~r], np.asarray(dsts)[~r]


def query_workload(g: CSR, q: int, kind: str, seed: int = 0):
    if kind == "random":
        return random_queries(g, q, seed)
    if kind == "positive":
        return positive_queries(g, q, seed)
    raise KeyError(kind)
