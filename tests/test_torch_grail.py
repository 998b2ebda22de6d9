"""The port's GRAIL baseline (``repro_torch.core.grail``) against the
reference's: the same graphs (the port's generators and the reference's
from one seed) give the same condensation, random post-order ranks, low
labels, levels and topological order bit for bit, and the query engine
the same answers (equal to brute force), the same ``nodes_expanded`` and
the same ``byte_size()``."""
import numpy as np
import pytest

from repro.core.grail import GrailQueryEngine as RefEngine
from repro.core.grail import build_grail as ref_build_grail
from repro.core.query import brute_force_closure
from repro.graphs import generators as ref_gen
from repro_torch.core.grail import GrailQueryEngine, build_grail
from repro_torch.graphs import generators as gen

GRAPHS = {"dag": lambda m, seed: m.random_dag(150, 2.5, seed=seed),
          "cyclic": lambda m, seed: m.scale_free_digraph(150, 3.0,
                                                         seed=seed)}
CASES = [(kind, seed) for kind in GRAPHS for seed in range(3)]
IDS = [f"{kind}-{seed}" for kind, seed in CASES]


def _pair(kind, seed, d=2):
    g, rg = GRAPHS[kind](gen, seed), GRAPHS[kind](ref_gen, seed)
    np.testing.assert_array_equal(g.indptr, rg.indptr)
    np.testing.assert_array_equal(g.indices, rg.indices)
    return g, rg, build_grail(g, d=d, seed=seed), ref_build_grail(
        rg, d=d, seed=seed)


@pytest.mark.parametrize("kind,seed", CASES, ids=IDS)
def test_build_matches_the_reference_bit_for_bit(kind, seed):
    _, _, ix, want = _pair(kind, seed)
    assert ix.d == want.d
    for name in ("rank", "low", "blevel", "tau"):
        got, ref = getattr(ix, name), getattr(want, name)
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_array_equal(ix.cond.comp, want.cond.comp)
    assert ix.cond.n_comp == want.cond.n_comp
    assert ix.byte_size() == want.byte_size()


@pytest.mark.parametrize("kind,seed", CASES, ids=IDS)
def test_queries_match_brute_force_and_the_reference(kind, seed):
    g, rg, ix, want = _pair(kind, seed)
    tc = brute_force_closure(rg)
    eng, ref = GrailQueryEngine(ix), RefEngine(want)
    srcs, dsts = np.meshgrid(np.arange(0, g.n, 3), np.arange(0, g.n, 5))
    srcs, dsts = srcs.ravel(), dsts.ravel()
    got = eng.batch(srcs, dsts)
    np.testing.assert_array_equal(got, tc[srcs, dsts])
    np.testing.assert_array_equal(got, ref.batch(srcs, dsts))
    assert eng.nodes_expanded == ref.nodes_expanded > 0
