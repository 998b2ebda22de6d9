"""Replicated and sharded serving in the port (``repro_torch.core.
distributed``) against the reference's one-device session, on the CPU.

Each case starts its ranks as subprocesses of one gloo process group
(a FileStore under the test's temporary directory, no network): world 2
with meshes 2x1 (replicated) and 1x2 (sharded), world 4 with 2x2
(sharded). Every rank serves the same batches through a
``repro_torch.reach.QuerySession`` built from the graph, loaded from the
reference's artifact, or under live inserts (``apply_updates``, then
``compact``), and must return the reference's answers with its phase
mix; the index is weak (k = 1, deep layered DAG) and the frontier cap
small, so a residue reaches the sparse phase 2 and overflows into retries.
The reference runs its XLA loop, whose overflow rule differs from the
fused rule the port keeps, so ``sparse_retries`` may differ. Kernel 1's
owned-rows entry's plain version is held to the reference's packed rule
on gathered rows; the mesh and the engine's refusals run in-process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import reach as ref_reach
from repro.core.query import brute_force_closure
from repro.core.workload import positive_queries, random_queries
from repro.graphs import generators as ref_gen
from repro.graphs.csr import build_csr as ref_build_csr
from repro.kernels import ref as jref
from repro_torch import reach
from repro_torch.core import distributed as D
from repro_torch.core.packed import pack_index
from repro_torch.kernels import interval_stab as stab

SRC = Path(__file__).resolve().parents[1] / "src"
RANK_TIMEOUT = 90            # seconds, each rank's subprocess
SPEC = dict(k=1, variant="L", n_seeds=32, phase2_mode="sparse",
            frontier_cap=64, max_batch=2048, min_bucket=256,
            overlay_cap=256)
PHASE_MIX = ("n_queries", "n_positive", "phase1_pos", "phase1_neg",
             "phase2_queries", "phase2_sparse", "phase2_host",
             "n_updates", "n_overlay_hits", "n_compactions",
             "overlay_edges")
N_BATCHES = 2                # insert batches of the live-update cases
N_LIVE = 768                 # the queries served under them

RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
dist.init_process_group("gloo", rank=rank, world_size=cfg["world"],
                        store=dist.FileStore(cfg["store"], cfg["world"]))
from repro_torch import reach
from repro_torch.graphs.csr import CSR
data = np.load(cfg["data"])
spec = reach.IndexSpec(**cfg["spec"], placement=cfg["placement"],
                       mesh=cfg["mesh"])
if cfg["mode"] == "loaded":
    sess = reach.QuerySession.load(cfg["artifact"], spec, device="cpu")
else:
    g = CSR(int(data["n"]), data["indptr"], data["indices"])
    sess = reach.QuerySession(reach.build(g, spec), spec, device="cpu")
assert type(sess.engine).__name__ == "DistributedQueryEngine"
out = {"answers": sess.query(data["qs"], data["qt"])}
if cfg["mode"] == "updates":
    ls, lt = data["ls"], data["lt"]
    for i in range(data["n_batches"]):
        applied = sess.apply_updates(data[f"us{i}"], data[f"ud{i}"])
        out[f"applied{i}"] = np.array(applied)
        out[f"answers{i}"] = sess.query(ls, lt)
    out["builder"] = np.array(sess.compact().builder)
    out["compacted"] = sess.query(ls, lt)
np.savez(cfg["out"] % rank, **out)
st = sess.stats.as_dict()
with open(cfg["out"] % rank + ".json", "w") as f:
    json.dump({k: v for k, v in st.items() if isinstance(v, int)}, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The graph, the queries, the insert batches and the reference's
    artifact, answers and phase mix (one device, XLA loop)."""
    tmp = tmp_path_factory.mktemp("distributed")
    g = ref_gen.layered_dag(2000, 16, 3.0, seed=3)
    qs, qt = random_queries(g, 1536, seed=5)
    ps, pt = positive_queries(g, 512, seed=6)
    qs, qt = np.concatenate([qs, ps]), np.concatenate([qt, pt])
    ref_spec = ref_reach.IndexSpec(**SPEC)
    ix = ref_reach.build(g, ref_spec)
    ref_reach.save_index(tmp / "artifact", ix, ref_spec)
    want = {}
    sess = ref_reach.QuerySession(ix, ref_spec)
    want["answers"] = sess.query(qs, qt)
    want["stats"] = sess.stats
    # inserts forward in id order (the layered DAG stays acyclic), a share
    # of them the pairs of negative answers, which they turn positive
    ls, lt = qs[:N_LIVE], qt[:N_LIVE]
    neg = np.flatnonzero(~want["answers"][:N_LIVE] & (ls < lt))
    rng = np.random.default_rng(7)
    data = {"n": np.array(g.n), "indptr": g.indptr, "indices": g.indices,
            "qs": qs, "qt": qt, "ls": ls, "lt": lt,
            "n_batches": np.array(N_BATCHES)}
    for i in range(N_BATCHES):
        us = rng.integers(0, g.n, 24)
        ud = rng.integers(0, g.n, 24)
        lo, hi = np.minimum(us, ud), np.maximum(us, ud)
        keep = lo != hi
        flip = neg[i * 4:(i + 1) * 4]
        data[f"us{i}"] = np.concatenate([lo[keep], ls[flip]])
        data[f"ud{i}"] = np.concatenate([hi[keep], lt[flip]])
    np.savez(tmp / "data.npz", **data)
    sess = ref_reach.QuerySession(ix, ref_spec)
    np.testing.assert_array_equal(sess.query(qs, qt), want["answers"])
    src, dst = (list(a) for a in g.edges())
    for i in range(N_BATCHES):
        want[f"applied{i}"] = sess.apply_updates(data[f"us{i}"],
                                                 data[f"ud{i}"])
        want[f"answers{i}"] = sess.query(ls, lt)
        src += list(data[f"us{i}"])
        dst += list(data[f"ud{i}"])
    closure = brute_force_closure(ref_build_csr(g.n, np.array(src),
                                                np.array(dst)))
    want["closure"] = closure[ls, lt]
    want["builder"] = sess.compact().builder
    want["compacted"] = sess.query(ls, lt)
    want["update_stats"] = sess.stats
    return tmp, want


def _serve(tmp, mode, placement, mesh):
    """The ranks' outputs: one npz and one stats dict a rank."""
    d, m = (int(x) for x in mesh.split("x"))
    n = d * m
    case = tmp / f"{mode}_{placement}_{mesh}"
    case.mkdir()
    cfg = {"world": n, "store": str(case / "store"),
           "data": str(tmp / "data.npz"), "artifact": str(tmp / "artifact"),
           "spec": SPEC, "placement": placement, "mesh": mesh,
           "mode": mode, "out": str(case / "rank%d.npz")}
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, json.dumps(cfg),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [dict(np.load(cfg["out"] % r)) for r in range(n)]
    stats = [json.loads(Path(cfg["out"] % r + ".json").read_text())
             for r in range(n)]
    return outs, stats


def _mix(stats) -> dict:
    return {f: (stats[f] if isinstance(stats, dict) else getattr(stats, f))
            for f in PHASE_MIX}


@pytest.mark.parametrize("mode,placement,mesh", [
    ("fresh", "replicated", "2x1"), ("fresh", "sharded", "1x2"),
    ("fresh", "sharded", "2x2"), ("loaded", "sharded", "1x2"),
    ("loaded", "replicated", "2x1"), ("updates", "sharded", "1x2"),
    ("updates", "sharded", "2x2"), ("updates", "replicated", "2x1"),
])
def test_placement_matches_reference_session(world, mode, placement, mesh):
    tmp, want = world
    outs, stats = _serve(tmp, mode, placement, mesh)
    for out, st in zip(outs[1:], stats[1:]):     # every rank the same
        assert st == stats[0]
        for key, v in out.items():
            np.testing.assert_array_equal(v, outs[0][key], err_msg=key)
    got = outs[0]
    np.testing.assert_array_equal(got["answers"], want["answers"])
    if mode != "updates":
        assert _mix(stats[0]) == _mix(want["stats"])
        assert stats[0]["phase2_sparse"] > 0 and stats[0]["sparse_retries"]
        return
    for i in range(N_BATCHES):
        assert int(got[f"applied{i}"]) == want[f"applied{i}"]
        np.testing.assert_array_equal(got[f"answers{i}"],
                                      want[f"answers{i}"], err_msg=str(i))
    np.testing.assert_array_equal(got[f"answers{N_BATCHES - 1}"],
                                  want["closure"])
    assert str(got["builder"]) == want["builder"]
    np.testing.assert_array_equal(got["compacted"], want["compacted"])
    assert _mix(stats[0]) == _mix(want["update_stats"])
    assert stats[0]["n_overlay_hits"] > 0


@pytest.mark.parametrize("n_model,k", [(1, 1), (2, 2), (3, 8)])
def test_owned_rows_plain_matches_reference_on_gathered_rows(n_model, k):
    """Kernel 1's owned-rows entry, plain version: summed over the shards
    it equals the reference's packed rule on the gathered rows, with the
    cs == ct fold, and each shard answers only for the sources it owns."""
    rng = np.random.default_rng(k)
    n, q = 301, 2000
    meta = rng.integers(-2**31, 2**31 - 1, (n, 4), dtype=np.int64)
    meta[:, 0] = rng.integers(0, 1 << 24, n) | (rng.integers(0, 256, n)
                                                << 24)
    meta[:, 1] = rng.integers(0, n, n)
    meta = meta.astype(np.int64).astype(np.uint32).view(np.int32)
    b = rng.integers(0, 1 << 24, (n, k))
    e = b + rng.integers(0, 1 << 20, (n, k))
    flag = rng.random((n, k)) < 0.3
    slab = np.concatenate([(b | (flag.astype(np.int64) << 31)).astype(
        np.uint32).view(np.int32), e.astype(np.int32)], axis=1)
    cs = rng.integers(0, n, q).astype(np.int32)
    ct = rng.integers(0, n, q).astype(np.int32)
    ct[:q // 8] = cs[:q // 8]
    want = np.asarray(jref.interval_stab_classify_packed_ref(
        meta[cs], meta[ct], slab[cs]))
    want = np.where(cs == ct, jref.POS, want)
    n_loc = -(-n // n_model)
    total = torch.zeros(q, dtype=torch.int32)
    for m in range(n_model):
        lo = m * n_loc
        rows = slice(lo, min(lo + n_loc, n))
        meta_m = torch.from_numpy(D._pad_rows(meta[rows], n_loc))
        slab_m = torch.from_numpy(D._pad_rows(slab[rows], n_loc))
        v = stab.stab_packed_owned(torch.from_numpy(meta[ct]), meta_m,
                                   slab_m, torch.from_numpy(cs),
                                   torch.from_numpy(ct), lo)
        own = (cs >= lo) & (cs < lo + n_loc)
        assert (v.numpy()[~own] == 0).all()
        total += v
    np.testing.assert_array_equal(total.numpy(), want)


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group in this process, torn down after."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _index():
    g = ref_gen.layered_dag(400, 8, 3.0, seed=1)
    return reach.build(g, reach.IndexSpec(**SPEC)), g


def test_make_engine_refuses_without_group_or_matching_mesh(group):
    ix, _ = _index()
    spec = reach.IndexSpec(**SPEC, placement="sharded", mesh="1x2")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        reach.make_engine(ix, spec, device="cpu")
    with pytest.raises(ValueError, match="single-device only"):
        D.DistributedQueryEngine(ix, D.ServingMesh("sharded", None, "cpu"),
                                 phase2_mode="dense")
    with pytest.raises(ValueError, match="single-device only"):
        reach.IndexSpec(**{**SPEC, "phase2_mode": "dense"},
                        placement="replicated")
    for placement in ("replicated", "sharded"):
        eng = reach.make_engine(ix, reach.IndexSpec(
            **{**SPEC, "phase2_mode": "auto"}, placement=placement),
            device="cpu")
        assert eng.phase2_mode == "sparse"
        assert eng.mesh.shape == (1, 1) and eng.mesh.rank == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        D.ServingMesh("replicated", (1, 2), "cpu")
    with pytest.raises(ValueError, match="placement must be one of"):
        D.ServingMesh("single", None, "cpu")


def test_make_engine_needs_a_process_group():
    ix, _ = _index()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialise the process group"):
        reach.make_engine(ix, reach.IndexSpec(**SPEC, placement="sharded"),
                          device="cpu")


def test_world_one_sharded_session_and_cell_match_single(group):
    """At world 1 (mesh 1x1) the sharded engine's exchange is the identity:
    its answers and phase mix equal the one-device engine's, and the
    ferrari cell's sharded step equals its replicated one."""
    from dataclasses import replace

    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    ix, g = _index()
    qs, qt = random_queries(g, 2000, seed=2)
    single = reach.QuerySession(ix, reach.IndexSpec(**SPEC), device="cpu")
    want = single.query(qs, qt)
    for placement in ("replicated", "sharded"):
        sess = reach.QuerySession(ix, reach.IndexSpec(**SPEC,
                                                      placement=placement),
                                  device="cpu")
        np.testing.assert_array_equal(sess.query(qs, qt), want)
        assert _mix(sess.stats.as_dict()) == _mix(single.stats.as_dict())
    mesh = sess.engine.mesh
    cfg = replace(get_smoke("ferrari-web"), n_nodes=ix.tl.n)
    pk = pack_index(ix, k_max=cfg.k_max)
    slab, meta = pk.fused_layout()
    cell = api.build_cell(cfg, "classify_100k", mesh=mesh)
    plain = api.build_cell(cfg, "classify_100k", device="cpu")
    state = D.shard_tables(slab, meta, mesh)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: s for k, (s, _) in cell.state_shapes.items()}
    (q,), _ = cell.batch_shapes["cs"]
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, ix.tl.n, q).astype(
        np.int32)) for k in ("cs", "ct")}
    _, got = cell.step(state, batch)
    _, ref_v = plain.step({"slab": torch.from_numpy(slab),
                           "meta": torch.from_numpy(meta)}, batch)
    np.testing.assert_array_equal(got.numpy(), ref_v.numpy())
