"""The port's tree cover and seed labels, computed a Kahn front at a time,
against the reference's node-at-a-time loops on the same graphs: Kahn's
FIFO order, backward levels, post-order numbers, tree intervals and both
seed bitsets equal; a cycle raises as in the reference. Also the device
build's label check (``labels_from_wavefront``), which raises where
``intervals.make_set`` raises, and ``build_csr`` against the
reference's."""
import numpy as np
import pytest

from repro.core import seeds as ref_seeds
from repro.core import tree_cover as ref_tc
from repro.graphs import generators as ref_gen
from repro.graphs.csr import build_csr as ref_build_csr
from repro_torch.core import seeds, tree_cover
from repro_torch.core.build import build_wavefront, labels_from_wavefront
from repro_torch.graphs import generators as gen
from repro_torch.graphs.csr import build_csr


def _random_dag(m, n, e, seed, dedup):
    """Edges from lower to higher rank under a random permutation, with
    duplicate edges kept when ``dedup`` is off."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, e), rng.integers(0, n, e)
    perm = rng.permutation(n)
    keep = a != b
    s, d = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    return m.build_csr(n, perm[s], perm[d], dedup=dedup)


class _Csr:
    build_csr = staticmethod(build_csr)


class _RefCsr:
    build_csr = staticmethod(ref_build_csr)


GRAPHS = {
    "scale_free": lambda m, c: m.scale_free_digraph(3000, 4.0, seed=1,
                                                    back_p=0.0),
    "tree": lambda m, c: m.random_tree(500, seed=2),
    "deep_path": lambda m, c: m.deep_path_dag(400, seed=3),
    "layered": lambda m, c: m.layered_dag(400, 16, 3.0, seed=4),
    "duplicates": lambda m, c: _random_dag(c, 200, 700, 5, dedup=False),
    "permuted": lambda m, c: _random_dag(c, 250, 900, 6, dedup=True),
    "sparse": lambda m, c: _random_dag(c, 300, 40, 7, dedup=True),
    "no_edges": lambda m, c: c.build_csr(5, [], []),
    "one_node": lambda m, c: c.build_csr(1, [], []),
}


def _pair(name):
    return GRAPHS[name](ref_gen, _RefCsr), GRAPHS[name](gen, _Csr)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tree_labels_match_reference(name):
    g_ref, g = _pair(name)
    want = ref_tc.build_tree_labels(g_ref)
    got = tree_cover.build_tree_labels(g)
    for f in ("tau", "pi", "tbegin", "parent", "blevel"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.tree_children.indptr,
                                  want.tree_children.indptr)
    np.testing.assert_array_equal(got.tree_children.indices,
                                  want.tree_children.indices)
    tau = ref_tc.topological_order(g_ref)
    np.testing.assert_array_equal(tree_cover.topological_order(g), tau)
    np.testing.assert_array_equal(tree_cover.backward_levels(g),
                                  ref_tc.backward_levels(g_ref, tau))


@pytest.mark.parametrize("n_seeds", [1, 32, 40])
@pytest.mark.parametrize("name", ["scale_free", "duplicates", "deep_path",
                                  "no_edges"])
def test_seed_labels_match_reference(name, n_seeds):
    g_ref, g = _pair(name)
    want = ref_seeds.build_seed_labels(g_ref, n_seeds=n_seeds)
    got = seeds.build_seed_labels(g, n_seeds=n_seeds)
    for f in ("seed_ids", "s_plus", "s_minus"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def test_cycle_raises_as_reference():
    cyc = ([0, 1, 2, 3], [1, 2, 0, 1])
    with pytest.raises(ValueError, match="not a DAG") as want:
        ref_tc.topological_order(ref_build_csr(4, *cyc))
    with pytest.raises(ValueError, match="not a DAG") as got:
        tree_cover.topological_order(build_csr(4, *cyc))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fault,message", [
    ("begin_after_end", "begin > end"),
    ("overlap", "sorted and disjoint"),
])
def test_labels_from_wavefront_checks_rows(fault, message):
    """A table row broken within its count raises; the same cell past the
    count is not read."""
    wf = build_wavefront(gen.random_dag(120, 2.5, seed=3), k=2,
                         variant="L", device="cpu")
    labels_from_wavefront(wf)
    v = int(np.flatnonzero(wf.counts[:wf.tl.n] >= 2)[0])
    past = wf.counts[v]
    if past < wf.begins.shape[1]:
        wf.begins[v, past] = wf.ends[v, past] + 5     # not live: ignored
        labels_from_wavefront(wf)
    if fault == "begin_after_end":
        wf.begins[v, 1] = wf.ends[v, 1] + 1
    else:
        wf.begins[v, 1] = wf.ends[v, 0]
    with pytest.raises(ValueError, match=message):
        labels_from_wavefront(wf)


@pytest.mark.parametrize("n,m,dedup", [(1, 3, True), (5, 0, True),
                                       (50, 400, True), (50, 400, False),
                                       (3000, 20000, True)])
def test_build_csr_matches_reference(n, m, dedup):
    """The CSR the port builds (sorted unique keys by a sort) equals the
    reference's, duplicate and self edges included."""
    rng = np.random.default_rng(n + m)
    s, d = rng.integers(0, n, m), rng.integers(0, n, m)
    want = ref_build_csr(n, s, d, dedup=dedup)
    got = build_csr(n, s, d, dedup=dedup)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indices.dtype == want.indices.dtype
