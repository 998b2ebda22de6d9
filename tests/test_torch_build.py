"""The port's host build (its own numpy copy of the reference modules)
gives arrays identical to the reference's ``build_index`` + ``pack_index``
+ ``fused_layout`` + ``ell_layout``, and ``to_torch`` holds the same words
as the reference ``to_device``."""
import numpy as np
import pytest
import torch

from repro.core.ferrari import build_index as ref_build
from repro.core.packed import pack_index as ref_pack
from repro.graphs import generators as ref_gen
from repro_torch.core.ferrari import build_index
from repro_torch.core.packed import pack_index
from repro_torch.graphs import generators as gen

GRAPHS = {
    "random_dag": lambda m: m.random_dag(300, 2.0, seed=1),
    "scale_free": lambda m: m.scale_free_digraph(500, 3.0, seed=2),
    "layered": lambda m: m.layered_dag(400, 16, 3.0, seed=3),
    # a web-style hub: out-degree 120 overflows the ELL width into the tail
    "hub": lambda m: m.add_hub_edges(m.scale_free_digraph(400, 3.0, seed=4),
                                     120, seed=5),
}


def _both(graph, **kw):
    g_ref, g = GRAPHS[graph](ref_gen), GRAPHS[graph](gen)
    np.testing.assert_array_equal(g_ref.indptr, g.indptr)
    np.testing.assert_array_equal(g_ref.indices, g.indices)
    return ref_build(g_ref, **kw), build_index(g, **kw)


def _assert_index_equal(a, b):
    for f in ("comp", "comp_size"):
        np.testing.assert_array_equal(getattr(a.cond, f), getattr(b.cond, f))
    np.testing.assert_array_equal(a.cond.dag.indptr, b.cond.dag.indptr)
    np.testing.assert_array_equal(a.cond.dag.indices, b.cond.dag.indices)
    for f in ("tau", "pi", "tbegin", "parent", "blevel"):
        np.testing.assert_array_equal(getattr(a.tl, f), getattr(b.tl, f))
    assert len(a.labels) == len(b.labels)
    for la, lb in zip(a.labels, b.labels):
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)
    assert (a.seeds is None) == (b.seeds is None)
    if a.seeds is not None:
        for f in ("seed_ids", "s_plus", "s_minus"):
            np.testing.assert_array_equal(getattr(a.seeds, f),
                                          getattr(b.seeds, f))
    assert (a.stats.n_comp, a.stats.total_intervals, a.stats.exact_intervals,
            a.stats.budget, a.stats.heap_recover_count) == \
        (b.stats.n_comp, b.stats.total_intervals, b.stats.exact_intervals,
         b.stats.budget, b.stats.heap_recover_count)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("k,variant,use_seeds,n_seeds", [
    (2, "G", True, 32), (1, "L", False, 32), (3, "L", True, 8),
    (2, "G", True, 64),
])
def test_build_and_pack_identical(graph, k, variant, use_seeds, n_seeds):
    ix_ref, ix = _both(graph, k=k, variant=variant, use_seeds=use_seeds,
                       n_seeds=n_seeds)
    _assert_index_equal(ix_ref, ix)
    p_ref, p = ref_pack(ix_ref), pack_index(ix)
    for f in ("begins", "ends", "exact", "pi", "tau", "blevel",
              "adj_indptr", "adj_indices", "comp"):
        np.testing.assert_array_equal(getattr(p_ref, f), getattr(p, f))
    assert (p_ref.n, p_ref.k_max, p_ref.max_out_degree) == \
        (p.n, p.k_max, p.max_out_degree)
    for a, b in zip(p_ref.fused_layout(), p.fused_layout()):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for width in (None, 2):
        for a, b in zip(p_ref.ell_layout(width=width),
                        p.ell_layout(width=width)):
            np.testing.assert_array_equal(a, b)


def test_hub_forces_coo_tail():
    _, ix = _both("hub", k=2, variant="G")
    ell, tsrc, tdst = pack_index(ix).ell_layout()
    assert ell.shape[1] == 32 and tsrc.size > 0 and tsrc.size == tdst.size


@pytest.mark.parametrize("n_seeds", [32, 64])
def test_to_torch_matches_to_device(n_seeds):
    ix_ref, ix = _both("scale_free", k=2, variant="G", n_seeds=n_seeds)
    dev_ref = ref_pack(ix_ref).to_device()
    dev = pack_index(ix).to_torch("cpu")
    assert set(dev) == set(dev_ref) | {"comp"}
    assert ("slab" in dev) == (n_seeds == 32)
    for key, want in dev_ref.items():
        got = dev[key]
        assert got.dtype == torch.int32 and got.is_contiguous()
        # uint32 seed words travel as int32 views of the same bits
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(dev["comp"].numpy(), ix_ref.cond.comp)
