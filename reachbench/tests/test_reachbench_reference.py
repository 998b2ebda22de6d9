"""The plain reference against a brute-force closure on small graphs."""
from collections import deque

import numpy as np
import pytest

from reachbench import gen, reference


def _hops(n, src, dst, s):
    """Hops from s to every node (-1: unreachable), by a plain BFS."""
    adj = [[] for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].append(b)
    dist = [-1] * n
    dist[s] = 0
    todo = deque([s])
    while todo:
        v = todo.popleft()
        for w in adj[v]:
            if dist[w] < 0:
                dist[w] = dist[v] + 1
                todo.append(w)
    return dist


def _dag(n, m, seed, dups=True):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, m)
    b = rng.integers(0, n, m)
    keep = a != b
    src, dst = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    # relabel by a permutation, so ids are not a topological order
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    if dups:
        src, dst = np.r_[src, src[:5]], np.r_[dst, dst[:5]]
    return src, dst


GRAPHS = [(60, 150, 0), (200, 300, 1), (200, 900, 2), (1, 0, 3), (130, 0, 4)]


@pytest.mark.parametrize("n,m,seed", GRAPHS)
def test_reach_answers_match_a_brute_force_closure(n, m, seed):
    src, dst = _dag(n, m, seed)
    rng = np.random.default_rng(seed + 100)
    qs = np.r_[rng.integers(0, n, 300), np.arange(min(n, 70))]
    qt = np.r_[rng.integers(0, n, 300), np.arange(min(n, 70))]
    dist = {s: _hops(n, src, dst, s) for s in set(qs.tolist())}
    want = np.array([dist[s][t] >= 0 for s, t in zip(qs.tolist(),
                                                       qt.tolist())])
    assert np.array_equal(reference.reach_answers(n, src, dst, qs, qt), want)


@pytest.mark.parametrize("hops", [0, 1, 2, 3])
def test_control_is_the_search_cut_at_its_hops(hops):
    n = 150
    src, dst = _dag(n, 400, 9)
    rng = np.random.default_rng(8)
    qs, qt = rng.integers(0, n, 500), rng.integers(0, n, 500)
    dist = {s: _hops(n, src, dst, s) for s in set(qs.tolist())}
    want = np.array([0 <= dist[s][t] <= hops for s, t in zip(qs.tolist(),
                                                              qt.tolist())])
    got = reference.control_answers(n, src, dst, qs, qt, hops)
    assert np.array_equal(got, want)


def test_more_than_64_sources_share_no_word_bits():
    n, s, d = gen.make_graph({"generator": "scale_free_digraph", "n": 3000,
                              "avg_deg": 2.0, "back_p": 0.0}, 6)
    rng = np.random.default_rng(2)
    qs, qt = rng.integers(0, n, 1000), rng.integers(0, n, 1000)
    got = reference.reach_answers(n, s, d, qs, qt)
    for i in range(0, 1000, 97):
        assert got[i] == (_hops(n, s, d, int(qs[i]))[int(qt[i])] >= 0)


def test_a_cycle_is_refused():
    with pytest.raises(ValueError, match="cycle"):
        reference.reach_answers(4, np.array([0, 1, 2]), np.array([1, 2, 0]),
                                np.array([0]), np.array([2]))


def test_kahn_levels_are_longest_paths():
    import torch
    src = torch.tensor([0, 1, 0, 2, 3])
    dst = torch.tensor([1, 2, 2, 3, 4])
    assert reference.kahn_levels(6, src, dst).tolist() == [0, 1, 2, 3, 4, 0]
