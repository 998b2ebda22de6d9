"""The plain reference: which pairs (s, t) of a DAG has a path s → t.

Worked out again from the generated edge lists alone, in plain PyTorch, with
nothing of the port: no condensation, no index, no packed tables. One bit a
source: every node holds a word of bits for each 64 sources, and a node's
words are its own bit OR its predecessors' words. Nodes are taken in Kahn
fronts (longest-path levels), so each front reads only finished words;
inside a front the in-edges go in rounds by their rank among their head's
in-edges, so no two edges of a round write one node.

``control_answers`` is the same search cut at a number of hops: the
guarantee it breaks is exactness (a pair farther apart reads "no").
"""
from __future__ import annotations

import numpy as np
import torch


def _as_long(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def kahn_levels(n: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Each node's longest-path level (sources 0). Raises ValueError when
    the graph has a cycle: the reference holds only for DAGs."""
    dev = src.device
    order = torch.argsort(src)
    heads = dst[order]
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    indeg = torch.bincount(dst, minlength=n)
    level = torch.full((n,), -1, dtype=torch.int64, device=dev)
    front = torch.nonzero(indeg == 0).flatten()
    depth, done = 0, 0
    while front.numel():
        level[front] = depth
        done += front.numel()
        lens = ptr[front + 1] - ptr[front]
        total = int(lens.sum())
        if not total:
            break
        first = torch.cumsum(lens, 0) - lens
        at = (torch.repeat_interleave(ptr[front] - first, lens)
              + torch.arange(total, device=dev))
        hit = heads[at]
        indeg -= torch.bincount(hit, minlength=n)
        hit = torch.unique(hit)
        front = hit[indeg[hit] == 0]
        depth += 1
    if done != n:
        raise ValueError(f"the graph has a cycle: {n - done} of {n} nodes "
                         "lie on or behind one")
    return level


def _rounds(key: torch.Tensor, dst: torch.Tensor):
    """Edges sorted by (key, head) and cut into rounds: a round holds the
    r-th in-edge of each head of one key, so no head twice. Returns the
    order and each round's length (host ints)."""
    n_heads = int(dst.max()) + 1 if dst.numel() else 1
    order = torch.argsort(key * n_heads + dst)
    k, d = key[order], dst[order]
    starts = torch.ones_like(d, dtype=torch.bool)
    starts[1:] = (k[1:] != k[:-1]) | (d[1:] != d[:-1])
    run = torch.cumsum(starts.long(), 0) - 1
    first = torch.nonzero(starts).flatten()
    rank = torch.arange(d.numel(), device=d.device) - first[run]
    key2 = k * (int(rank.max()) + 1 if rank.numel() else 1) + rank
    sub = torch.argsort(key2, stable=True)
    _, lens = torch.unique_consecutive(key2[sub], return_counts=True)
    return order[sub], lens.tolist()


def _seed_bits(n: int, qs: torch.Tensor):
    """Words [n, W] with bit j of source j set, and each pair's source
    column (the pairs' distinct sources get one column each)."""
    uniq, col = torch.unique(qs, return_inverse=True)
    w = (uniq.numel() + 63) // 64
    words = torch.zeros((n, max(w, 1)), dtype=torch.int64, device=qs.device)
    j = torch.arange(uniq.numel(), device=qs.device)
    words[uniq, j // 64] = torch.ones_like(j) << (j % 64)
    return words, col


def _read(words: torch.Tensor, qt: torch.Tensor, col: torch.Tensor):
    return (((words[qt, col // 64] >> (col % 64)) & 1) == 1).cpu().numpy()


def _or_rounds(words, src, dst, lens, into=None):
    """words[dst] |= words[src] round by round (``into``: write there and
    read ``words``, for a synchronous hop)."""
    out = words if into is None else into
    lo = 0
    for m in lens:
        s, d = src[lo:lo + m], dst[lo:lo + m]
        out[d] = out[d] | words[s]
        lo += m
    return out


def reach_answers(n: int, src, dst, qs, qt, device="cpu") -> np.ndarray:
    """Exact answers (bool [Q]) for pairs ``qs[i] → qt[i]`` over the DAG of
    ``n`` nodes and edges ``src → dst`` (duplicates allowed)."""
    src, dst = _as_long(src, device), _as_long(dst, device)
    qs, qt = _as_long(qs, device), _as_long(qt, device)
    level = kahn_levels(n, src, dst)
    order, lens = _rounds(level[dst], dst)
    words, col = _seed_bits(n, qs)
    _or_rounds(words, src[order], dst[order], lens)
    return _read(words, qt, col)


def control_answers(n: int, src, dst, qs, qt, hops: int,
                    device="cpu") -> np.ndarray:
    """The reference cut at ``hops`` hops: a pair answers "yes" only when a
    path of at most ``hops`` edges joins it."""
    src, dst = _as_long(src, device), _as_long(dst, device)
    qs, qt = _as_long(qs, device), _as_long(qt, device)
    order, lens = _rounds(torch.zeros_like(dst), dst)
    s, d = src[order], dst[order]
    words, col = _seed_bits(n, qs)
    for _ in range(hops):
        words = _or_rounds(words, s, d, lens, into=words.clone())
    return _read(words, qt, col)
