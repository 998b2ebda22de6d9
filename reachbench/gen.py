"""The benchmark's own graphs and query pairs, made from a seed.

Frozen copies of the port's ``graphs/generators.py::scale_free_digraph``
and ``core/workload.py::random_queries``: the same draws in the same order,
so a seed gives the same graph and pairs as the port's functions
(``tests/test_reachbench_gen.py`` holds them to it). They return edge lists, not the port's CSR: the harness hands the program its CSR
and the reference its own. ``walk_pairs`` replaces the port's
``positive_queries`` (one Python loop a query) by one numpy step over every
walk at once.
"""
from __future__ import annotations

import numpy as np


def _no_self_loops(src, dst):
    keep = src != dst
    return src[keep], dst[keep]


def scale_free_digraph(n: int, avg_deg: float, seed: int = 0,
                       back_p: float = 0.15):
    """Web-like digraph: targets drawn toward low ids (∝ 1/rank), each edge
    oriented low → high id except a ``back_p`` share. Returns (src, dst)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    u = rng.random(m)
    dst = np.minimum((n ** u).astype(np.int64), n - 1)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    back = rng.random(m) < back_p
    s = np.where(back, np.maximum(src, dst), np.minimum(src, dst))
    d = np.where(back, np.minimum(src, dst), np.maximum(src, dst))
    return _no_self_loops(s, d)


GRAPHS = {"scale_free_digraph": scale_free_digraph}


def make_graph(params: dict, seed: int):
    """(n, src, dst) of a configuration's ``graph`` entry: ``generator``
    names one of ``GRAPHS``, the other keys are its arguments."""
    kw = {k: v for k, v in params.items() if k != "generator"}
    src, dst = GRAPHS[params["generator"]](seed=seed, **kw)
    return int(params["n"]), src, dst


def random_pairs(n: int, q: int, rng):
    """``q`` uniform random (s, t) pairs over ``n`` nodes."""
    return (rng.integers(0, n, size=q, dtype=np.int64),
            rng.integers(0, n, size=q, dtype=np.int64))


def random_queries(n: int, q: int, seed: int = 0):
    """The port's ``random_queries``: ``random_pairs`` from ``seed``."""
    return random_pairs(n, q, np.random.default_rng(seed))


def csr_arrays(n: int, src, dst, device="cpu"):
    """(indptr int64, indices int32) on the host: the out-edges without
    duplicates, each row sorted, as the port's ``build_csr`` lays them out.
    The sort runs on ``device`` (torch), in one call."""
    import torch
    key = (torch.from_numpy(np.asarray(src, np.int64)).to(device) * n
           + torch.from_numpy(np.asarray(dst, np.int64)).to(device))
    key = torch.unique(key, sorted=True)
    s = key // n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(s, minlength=n), 0)
    indices = (key - s * n).to(torch.int32)
    return indptr.cpu().numpy(), indices.cpu().numpy()


def walk_pairs(indptr, indices, q: int, rng, max_walk: int = 32):
    """``q`` positive pairs from forward walks of 1 to ``max_walk`` steps
    (uniform), each step to a uniform out-neighbour; a walk stops early at
    a node without out-edges. Sources are uniform, moved to a uniform node
    with out-edges where they have none. t is reachable from s by
    construction. All walks step together, one numpy step each."""
    n = indptr.size - 1
    deg = np.diff(indptr)
    src = rng.integers(0, n, size=q, dtype=np.int64)
    has_out = np.flatnonzero(deg > 0)
    if has_out.size:
        redirect = has_out[rng.integers(0, has_out.size, size=q)]
        src = np.where(deg[src] > 0, src, redirect)
    steps = rng.integers(1, max_walk + 1, size=q)
    v = src.copy()
    for k in range(max_walk):
        live = np.flatnonzero((steps > k) & (deg[v] > 0))
        if not live.size:
            break
        at = v[live]
        pick = (rng.random(live.size) * deg[at]).astype(np.int64)
        v[live] = indices[indptr[at] + pick]
    return src, v
