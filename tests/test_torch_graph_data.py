"""The port's graph data pipeline on the CPU against the JAX package:
``synthetic_dataset``, ``NeighborSampler`` and ``query_workload`` give the
reference's arrays, and ``ReachabilityService`` gives the reference's
answers, on the host ``QueryEngine`` (``device=False`` in both packages)
and through the device engine on ``device="cpu"`` (the kernels' plain
versions; the reference's on JAX's CPU), whose answers must equal the host
DFS's too. Integers throughout, so every check is equality.
"""
import numpy as np
import pytest

from repro.data import graph_data as ref_gd
from repro_torch.data import graph_data as gd

pytestmark = pytest.mark.arch


@pytest.mark.parametrize("name", ["cora", "reddit"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_dataset_matches_reference(name, seed):
    g, feats, labels, n_classes = gd.synthetic_dataset(name, seed)
    rg, rfeats, rlabels, rn = ref_gd.synthetic_dataset(name, seed)
    assert n_classes == rn
    np.testing.assert_array_equal(g.indptr, rg.indptr)
    np.testing.assert_array_equal(g.indices, rg.indices)
    np.testing.assert_array_equal(feats, rfeats)
    np.testing.assert_array_equal(labels, rlabels)


def test_unknown_dataset_raises():
    with pytest.raises(KeyError):
        gd.synthetic_dataset("citeseer")


@pytest.mark.parametrize("fanout,step", [((5, 3), 0), ((15, 10), 2),
                                         ((4,), 1)])
def test_neighbor_sampler_matches_reference(fanout, step):
    g, *_ = gd.synthetic_dataset("reddit")
    rg, *_ = ref_gd.synthetic_dataset("reddit")
    targets = np.random.default_rng(step).choice(g.n, 64, replace=False)
    got = gd.NeighborSampler(g, fanout, seed=4).sample(targets, step)
    want = ref_gd.NeighborSampler(rg, fanout, seed=4).sample(targets, step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    nodes, src, dst = got
    np.testing.assert_array_equal(nodes[:64], targets)    # targets first
    assert src.max() < len(nodes) and dst.max() < len(nodes)


@pytest.mark.parametrize("kind", ["random", "positive"])
def test_query_workload_matches_reference(kind):
    g, *_ = gd.synthetic_dataset("cora")
    rg, *_ = ref_gd.synthetic_dataset("cora")
    for a, b in zip(gd.query_workload(g, 500, kind, seed=2),
                    ref_gd.query_workload(rg, 500, kind, seed=2)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        gd.query_workload(g, 5, "hub")


@pytest.fixture(scope="module")
def cora():
    g, *_ = gd.synthetic_dataset("cora")
    rg, *_ = ref_gd.synthetic_dataset("cora")
    rng = np.random.default_rng(9)
    return g, rg, rng.integers(0, g.n, 3000), rng.integers(0, g.n, 3000)


@pytest.mark.parametrize("k", [1, 2])
def test_reachability_service_matches_reference(cora, k):
    g, rg, s, t = cora
    host = gd.ReachabilityService(g, k=k, device=False)
    assert host.engine is None
    want = ref_gd.ReachabilityService(rg, k=k, device=False).reachable(s, t)
    np.testing.assert_array_equal(host.reachable(s, t), want)
    dev = gd.ReachabilityService(g, k=k, device="cpu")
    assert dev.engine is not None and dev.engine.device.type == "cpu"
    got = dev.reachable(s, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref_gd.ReachabilityService(rg, k=k, device=True).reachable(s, t))
    np.testing.assert_array_equal(got, dev.host.batch(s, t))
    ks, kt = dev.filter_unreachable_pairs(s, t)
    np.testing.assert_array_equal(ks, s[~want])
    np.testing.assert_array_equal(kt, t[~want])
    assert 0 < len(ks) < len(s)


def test_reachability_service_defaults_to_the_card(cora):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gd.ReachabilityService(cora[0])
