"""Index artifacts shared by the two packages: an artifact saved by the
reference's ``reach.save_index`` loads in the port and the reverse, with
the spec, build stats, packed slabs and ELL layout intact and identical
answers; ``QuerySession.load`` serves what the saving session served; and
an artifact's delta log replays in the port as in the reference."""
import json

import numpy as np
import pytest

from repro import reach as ref_reach
from repro.graphs import generators as ref_gen
from repro.reach.persist import append_delta
from repro_torch import reach
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.core.workload import positive_queries, random_queries
from repro_torch.graphs import generators as gen

# a weak index (k=1, two seeds) so that phase 2 serves through the ELL
# layout the artifact carries
SPEC_KW = dict(k=1, variant="G", n_seeds=2, phase2_mode="sparse",
               ell_width=4, max_batch=1024, min_bucket=64)


def _graph(m):
    return m.scale_free_digraph(1200, 2.0, seed=11, back_p=0.2)


def _queries(g):
    rs, rt = random_queries(g, 1500, seed=3)
    ps, pt = positive_queries(g, 500, seed=4)
    return np.concatenate([rs, ps]), np.concatenate([rt, pt])


def _same_artifact_state(a, b):
    sa, ma = restore_checkpoint(a)
    sb, mb = restore_checkpoint(b)
    assert ma["leaf_paths"] == mb["leaf_paths"]
    assert ma["leaf_dtypes"] == mb["leaf_dtypes"]
    for p in ma["leaf_paths"]:
        np.testing.assert_array_equal(sa[p], sb[p], err_msg=p)
    for key in ("format_version", "kind", "epoch", "n_comp", "k", "variant",
                "spec", "user_meta", "k_max", "max_out_degree"):
        assert ma["extra"][key] == mb["extra"][key], key
    stats_a, stats_b = dict(ma["extra"]["stats"]), dict(mb["extra"]["stats"])
    for st in (stats_a, stats_b):          # wall-clock fields differ
        for key in [k for k in st if k.startswith("seconds")]:
            del st[key]
    assert stats_a == stats_b


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The same index saved by each package, and the answers of the
    sessions that saved them."""
    root = tmp_path_factory.mktemp("artifacts")
    g = _graph(gen)
    qs, qt = _queries(g)
    ref_spec = ref_reach.IndexSpec(**SPEC_KW)
    ref_ix = ref_reach.build(_graph(ref_gen), ref_spec)
    ref_reach.save_index(root / "ref", ref_ix, ref_spec, meta={"by": "ref"})
    ref_ans = ref_reach.QuerySession(ref_ix, ref_spec).query(qs, qt)
    spec = reach.IndexSpec(**SPEC_KW)
    ix = reach.build(g, spec)
    reach.save_index(root / "port", ix, spec, meta={"by": "ref"})
    ans = reach.QuerySession(ix, spec, device="cpu").query(qs, qt)
    return root, qs, qt, ref_ans, ans


def test_both_packages_write_the_same_artifact(saved):
    root, _, _, ref_ans, ans = saved
    np.testing.assert_array_equal(ans, ref_ans)
    _same_artifact_state(root / "ref", root / "port")
    assert latest_step(root / "port") == 0
    assert (root / "port" / "step_0.done").exists()


def test_reference_artifact_loads_in_port(saved):
    root, qs, qt, ref_ans, _ = saved
    art = reach.load_index(root / "ref")
    assert art.spec == reach.IndexSpec(**SPEC_KW)
    assert art.packed is not None and art.ell is not None
    assert art.index.stats.builder == "host"
    assert art.manifest["extra"]["user_meta"] == {"by": "ref"}
    sess = reach.QuerySession.load(root / "ref", device="cpu")
    assert sess.spec == art.spec and sess.epoch == 0
    assert sess.engine.packed is not None
    np.testing.assert_array_equal(sess.query(qs, qt), ref_ans)
    assert sess.stats.phase2_sparse > 0      # the loaded ELL layout served


def test_port_artifact_loads_in_reference(saved):
    root, qs, qt, _, ans = saved
    art = ref_reach.load_index(root / "port")
    assert art.spec == ref_reach.IndexSpec(**SPEC_KW)
    assert art.packed is not None and art.ell is not None
    sess = ref_reach.QuerySession.load(root / "port")
    np.testing.assert_array_equal(sess.query(qs, qt), ans)


def test_loaded_session_serves_what_the_saver_served(saved):
    root, qs, qt, _, ans = saved
    sess = reach.QuerySession.load(root / "port", device="cpu")
    got = sess.query(qs, qt)
    np.testing.assert_array_equal(got, ans)
    assert got[1500:].all()
    # a spec override with another ELL width rebuilds that layout
    wider = reach.IndexSpec(**{**SPEC_KW, "ell_width": 8})
    sess = reach.QuerySession.load(root / "port", wider, device="cpu")
    assert sess.spec.ell_width == 8
    np.testing.assert_array_equal(sess.query(qs, qt), ans)


def test_wavefront_artifact_round_trips(tmp_path):
    """A device-built index (CPU here) keeps its builder and MergeStats
    through both loaders."""
    g = gen.add_hub_edges(_graph(gen), 300, seed=5)
    spec = reach.IndexSpec(**SPEC_KW, builder="wavefront",
                           cover_method="topgap")
    ix = reach.build(g, spec, device="cpu")
    assert ix.stats.hub_nodes >= 1
    reach.save_index(tmp_path, ix, spec)
    qs, qt = _queries(g)
    want = reach.QuerySession(ix, spec, device="cpu").query(qs, qt)
    for sess in (reach.QuerySession.load(tmp_path, device="cpu"),
                 ref_reach.QuerySession.load(tmp_path)):
        assert sess.spec.builder == "wavefront"
        assert sess.index.stats.hub_nodes == ix.stats.hub_nodes
        assert sess.index.stats.merge_rounds == ix.stats.merge_rounds
        assert sess.index.stats.host_fallbacks == 0
        np.testing.assert_array_equal(sess.query(qs, qt), want)


def test_delta_log_replays(saved, tmp_path):
    """An artifact with a delta log for its epoch loads, and
    ``QuerySession.load`` replays the log into the overlay as the
    reference's does; a log of another epoch is not this artifact's."""
    root, qs, qt, _, _ = saved
    import shutil
    for name in ("port", "ref"):
        shutil.copytree(root / "ref", tmp_path / name)
        append_delta(tmp_path / name, 0, [1, 2, 7], [3, 4, 900])
    reach.load_index(tmp_path / "port")
    sess = reach.QuerySession.load(tmp_path / "port", device="cpu")
    ref = ref_reach.QuerySession.load(tmp_path / "ref")
    assert sess.stats.overlay_edges == ref.stats.overlay_edges > 0
    np.testing.assert_array_equal(sess.query(qs, qt), ref.query(qs, qt))
    shutil.copytree(root / "port", tmp_path / "b")
    append_delta(tmp_path / "b", 7, [1], [2])
    assert reach.QuerySession.load(tmp_path / "b",
                                   device="cpu").stats.overlay_edges == 0


def test_load_without_a_card_raises(saved, monkeypatch):
    import torch
    root, *_ = saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reach.QuerySession.load(root / "port")


def test_missing_or_foreign_artifact_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        reach.load_manifest(tmp_path)
    (tmp_path / "step_3").mkdir()
    (tmp_path / "step_3" / "manifest.json").write_text(json.dumps(
        {"extra": {"kind": "other"}}))
    (tmp_path / "step_3.done").touch()
    assert reach.load_manifest(tmp_path)["extra"]["kind"] == "other"
    with pytest.raises(ValueError, match="not a ferrari-index"):
        reach.load_index(tmp_path)
