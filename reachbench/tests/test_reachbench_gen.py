"""The benchmark's frozen generators against the port's, and the walk
pairs against the reference."""
import numpy as np
import pytest

from reachbench import gen, reference, traffic
from repro_torch.core import workload
from repro_torch.graphs import generators as G


@pytest.mark.parametrize("n,back_p,seed", [(4096, 0.0, 0), (20000, 0.0, 11),
                                           (3000, 0.15, 2), (8192, 0.0, 5),
                                           (50000, 0.0, 3), (2000, 0.3, 9)])
def test_scale_free_matches_the_port(n, back_p, seed):
    g = G.scale_free_digraph(n, 4.0, seed=seed, back_p=back_p)
    indptr, indices = gen.csr_arrays(n, *gen.scale_free_digraph(
        n, 4.0, seed=seed, back_p=back_p))
    assert np.array_equal(indptr, g.indptr)
    assert np.array_equal(indices, g.indices)


def test_random_queries_match_the_port():
    g = G.random_dag(500, 2.0, seed=1)
    want = workload.random_queries(g, 1000, seed=9)
    got = gen.random_queries(500, 1000, seed=9)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_make_graph_takes_the_config_entry():
    n, s, d = gen.make_graph({"generator": "scale_free_digraph", "n": 3000,
                              "avg_deg": 3.0, "back_p": 0.0}, 4)
    assert n == 3000 and np.array_equal(
        s, gen.scale_free_digraph(3000, 3.0, seed=4, back_p=0.0)[0])


@pytest.mark.parametrize("params", [
    {"generator": "scale_free_digraph", "n": 6000, "avg_deg": 4.0,
     "back_p": 0.0},
    {"generator": "scale_free_digraph", "n": 6000, "avg_deg": 1.5,
     "back_p": 0.0}])
def test_walk_pairs_are_reachable(params):
    n, s, d = gen.make_graph(params, 2)
    indptr, indices = gen.csr_arrays(n, s, d)
    rng = np.random.default_rng(3)
    qs, qt = gen.walk_pairs(indptr, indices, 4000, rng, max_walk=32)
    assert reference.reach_answers(n, s, d, qs, qt).all()
    deg = np.diff(indptr)
    assert (deg[qs] > 0).all()            # sources moved to nodes with edges
    assert (qs != qt).mean() > 0.9        # walks leave their source


def test_traffic_is_the_seeds_and_keeps_the_mix():
    n, s, d = gen.make_graph({"generator": "scale_free_digraph", "n": 5000,
                              "avg_deg": 4.0, "back_p": 0.0}, 1)
    tables = (n,) + gen.csr_arrays(n, s, d)
    mix = {"loop": "open", "rate_per_s": 200, "request_pairs": 16,
           "tenants": 3, "kinds": [["random", 3], ["walk", 1]],
           "sample_blocks": 4}
    a = traffic.window(tables, mix, 12, 2.0)
    b = traffic.window(tables, mix, 12, 2.0)
    c = traffic.window(tables, mix, 13, 2.0)
    assert np.array_equal(a.s, b.s) and np.array_equal(a.due, b.due)
    assert not np.array_equal(a.s, c.s)
    assert a.due.size == c.due.size == 400          # the same load a seed
    assert (np.diff(a.due) >= 0).all() and a.due.max() < 2.0
    kinds = a.kind[::a.block]
    assert (kinds == 1).sum() == 100 and (kinds[3::4] == 1).all()
    picked = traffic.sample_blocks(a, mix, 12)
    assert (kinds[picked] == 0).sum() == 4 and (kinds[picked] == 1).sum() == 4


def test_large_seeds_are_taken():
    mix = {"loop": "closed", "pairs_per_call": 64, "pool_calls": 2,
           "block": 16, "kinds": [["random", 1]]}
    tables = (100, np.zeros(101, np.int64), np.zeros(0, np.int32))
    w = traffic.window(tables, mix, 2**31 + 12345, 1.0)
    assert w.s.size == 128 and w.s.max() < 100
