"""The port's staged device build on the CPU (kernel 5's plain version)
against the reference's ``build_wavefront(kernel_impl="xla")`` and
``reach.build(builder="wavefront")`` on the same graphs: label tables,
counts, drain order and every MergeStats counter equal, for variants L and
G, with and without tree-reduction rounds; the planning helpers; the host
parity property; and the whole build → session path end to end."""
import numpy as np
import pytest

from repro import reach as ref_reach
from repro.core.build import build_wavefront as ref_build_wavefront
from repro.core.build import effective_widths as ref_effective_widths
from repro.core.build import plan_chunks as ref_plan_chunks
from repro.core.build import \
    prior_peak_slab_bytes as ref_prior_peak_slab_bytes
from repro.graphs import generators as ref_gen
from repro_torch import reach
from repro_torch.core import intervals as iv
from repro_torch.core.build import (build_wavefront, effective_widths,
                                    labels_from_wavefront, plan_chunks,
                                    prior_peak_slab_bytes)
from repro_torch.core.ferrari import build_index
from repro_torch.core.workload import positive_queries, random_queries
from repro_torch.graphs import generators as gen

RANDOM = lambda m: m.random_dag(150, 2.5, seed=0)                # noqa: E731
LAYERED = lambda m: m.layered_dag(240, 6, 3.0, seed=2)           # noqa: E731
HUB = lambda m: m.add_hub_edges(m.layered_dag(200, 5, 1.5,       # noqa: E731
                                              seed=3), 90, seed=4)


@pytest.mark.parametrize("graph,kw", [
    (RANDOM, dict(k=2, variant="L")),
    (LAYERED, dict(k=2, variant="G")),
    # the hub's 90+ children exceed the cap: 4 tree-reduction rounds
    (HUB, dict(k=2, variant="L", merge_chunk=4, m_cap=9)),
    (HUB, dict(k=1, variant="G", c=4, merge_chunk=4, m_cap=17)),
])
def test_build_wavefront_matches_reference_xla(graph, kw):
    want = ref_build_wavefront(graph(ref_gen), kernel_impl="xla", **kw)
    got = build_wavefront(graph(gen), device="cpu", **kw)
    for name in ("begins", "ends", "exact", "counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.exact.dtype == np.bool_
    for name in ("drain_order", "hub_nodes", "merge_rounds",
                 "host_fallbacks", "peak_slab_bytes", "levels"):
        assert getattr(got, name) == getattr(want, name), name
    # the dummy row stays empty
    assert (got.begins[-1] == 2**31 - 1).all() and got.counts[-1] == 0
    if graph is HUB:
        assert got.hub_nodes >= 1 and got.merge_rounds >= 2
        assert got.host_fallbacks == 0
    if kw["variant"] == "G":                     # the budget k·n holds
        assert got.counts[:-1].sum() <= kw["k"] * (got.counts.size - 1)


def test_planning_helpers_match_reference():
    counts = np.array([7, 1, 64, 65, 128, 0, 300])
    for chunk in (2, 16, 64):
        for a, b in zip(plan_chunks(counts, chunk),
                        ref_plan_chunks(counts, chunk)):
            np.testing.assert_array_equal(a, b)
    for args in [(2, 64, None), (2, 300, None), (2, 64, 33), (8, 64, None),
                 (8, 64, 513), (1, 2, 3)]:
        assert effective_widths(*args) == ref_effective_widths(*args)
    with pytest.raises(ValueError):
        effective_widths(8, 64, 16)
    g = gen.add_hub_edges(gen.layered_dag(400, 15, 3.0, seed=4), 120, seed=2)
    rng = np.random.default_rng(0)
    blevel = rng.integers(0, 15, g.n)
    for w_out in (2, 8):
        for scope in ("wave", "global"):
            assert (prior_peak_slab_bytes(g.degrees(), blevel, w_out, scope)
                    == ref_prior_peak_slab_bytes(g.degrees(), blevel, w_out,
                                                 scope))


@pytest.mark.parametrize("seed", [0, 7, 1234, 99991])
def test_wavefront_bit_identical_to_host(seed):
    """Without hubs, the device build's labels equal the host FERRARI-L
    top-gap sweep's (the reference's tests/test_wavefront.py property)."""
    g = gen.random_dag(250, 2.5, seed=seed)
    host = build_index(g, k=2, variant="L", cover_method="topgap",
                       use_seeds=False, precondensed=True)
    wf = build_wavefront(g, k=2, variant="L", device="cpu")
    assert wf.hub_nodes == 0
    for v, lab in enumerate(labels_from_wavefront(wf)):
        assert iv.to_tuples(host.labels[v]) == iv.to_tuples(lab), v


def test_reach_build_wavefront_end_to_end_matches_reference():
    """A graph with SCCs and one hub above the single-shot cap, at the
    default widths (k=2, G, c=4: W=8, m_cap=2049): labels, seeds and
    session answers equal to the reference's device build."""
    def graph(m):
        return m.add_hub_edges(m.scale_free_digraph(1500, 1.5, seed=42,
                                                    back_p=0.2), 400, seed=7)
    kw = dict(builder="wavefront", cover_method="topgap")
    want = ref_reach.build(graph(ref_gen), ref_reach.IndexSpec(**kw))
    g = graph(gen)
    spec = reach.IndexSpec(**kw)
    got = reach.build(g, spec, device="cpu")
    assert got.stats.hub_nodes >= 1 and got.stats.merge_rounds >= 2
    assert got.stats.host_fallbacks == 0
    assert got.cond.n_comp < g.n                     # SCCs condensed
    for name in ("builder", "hub_nodes", "merge_rounds", "host_fallbacks",
                 "peak_slab_bytes", "total_intervals", "exact_intervals",
                 "heap_recover_count", "n_comp"):
        assert getattr(got.stats, name) == getattr(want.stats, name), name
    assert len(got.labels) == len(want.labels)
    for v, (a, b) in enumerate(zip(got.labels, want.labels)):
        assert iv.to_tuples(a) == iv.to_tuples(b), v
    np.testing.assert_array_equal(got.seeds.s_plus, want.seeds.s_plus)
    np.testing.assert_array_equal(got.seeds.s_minus, want.seeds.s_minus)

    rs, rt = random_queries(g, 3000, seed=1)
    ps, pt = positive_queries(g, 1000, seed=2)
    qs, qt = np.concatenate([rs, ps]), np.concatenate([rt, pt])
    ans = reach.QuerySession(got, spec, device="cpu").query(qs, qt)
    ref_ans = ref_reach.QuerySession(want, ref_reach.IndexSpec(**kw)).query(
        qs, qt)
    np.testing.assert_array_equal(ans, ref_ans)
    assert ans[3000:].all()
