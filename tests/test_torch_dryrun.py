"""The port's dry run (``repro_torch.launch.dryrun``) and op profile
(``launch.opprof``): each cell's step evaluated on ``meta`` tensors on a
fake process group the size of its mesh, against the reference's dry run
and against real steps on gloo ranks.

  * One SMOKE cell per family on a 2x2 mesh: the rank's ``argument_bytes``
    equal the reference's ``memory_analysis().argument_size_in_bytes``
    (``repro.launch.dryrun._compile_once`` on a 2x2 mesh of 4 XLA host
    devices, in a subprocess), and ``model_flops`` the reference's. The
    LM cell is tinyllama's SMOKE config widened to head dim 64, which
    kernel 6 takes (the card's kernels refuse head dim 16, and the dry
    run refuses what the card would). The sharded ferrari cell differs by
    a reason ROADMAP names (its "deliberate differences"): the
    reference's ``state_shardings()`` leave the table rows replicated,
    the port's split them over 'model', so the reference counts the
    (M − 1) / M of the tables that the port's rank does not hold.
  * Rank 0's and the last rank's collectives (count and bytes by kind)
    equal those a real step of the same cell records on 4 gloo ranks
    (subprocesses, a FileStore under the test's temporary directory) at
    2x2, for the LM train and decode cells, a GNN full-graph and a
    dense-batch cell, MIND's train cell and the sharded ferrari cell.
  * One published cell per family on the 16x16 mesh is ``ok`` with its
    kernels' launches (llama3-8b's prefill_32k: kernel 6 once a layer).
  * The op profile of a 32-layer cell has as many rows as its 2-layer
    cut: every layer folds into the same rows.
  * The wrappers' ``meta`` branch: outputs of the launch path's shapes and
    dtypes, the call in ``work.TALLY``, no launch counted.

Every fake process group is torn down as its run ends.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import shapes_for_family
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.kernels import _lib, work
from repro_torch.kernels import batched_mp as bm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import interval_stab as st
from repro_torch.kernels import retrieval_score as rs
from repro_torch.launch import dryrun, opprof

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 300                  # seconds, each subprocess
MESH = ((2, 2), ("data", "model"))
LM_WIDE = dict(d_model=512, n_heads=8, n_kv_heads=2)     # head dim 64
# (tag, arch, shape, config overrides) at the published shapes
REF_CELLS = (("lm", "tinyllama-1.1b", "train_4k", LM_WIDE),
             ("gnn", "gin-tu", "molecule", {}),
             ("recsys", "mind", "train_batch", {}),
             ("ferrari", "ferrari-web", "classify_100k", {}))
# (tag, arch, shape, config overrides, shape overrides): small enough to
# step for real on the CPU
GLOO_CELLS = (
    ("lm-train", "tinyllama-1.1b", "train_4k", LM_WIDE,
     dict(batch=8, seq_len=32)),
    ("lm-decode", "tinyllama-1.1b", "decode_32k", LM_WIDE,
     dict(batch=2, seq_len=16)),
    ("gnn-full", "gcn-cora", "full_graph_sm", {}, {}),
    ("gnn-dense", "gin-tu", "molecule", {}, dict(batch_graphs=8)),
    ("recsys-train", "mind", "train_batch", {}, dict(batch=8)),
    ("ferrari", "ferrari-web", "classify_100k", {}, dict(n_queries=1000)))


def _cfg(get, arch, over):
    return replace(get(arch), **over)


def _shape(cfg, shape_name, over):
    return replace(shapes_for_family(cfg.family)[shape_name], **over)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(SRC), **extra)


# ---------------------------------------- the reference's dry run, 2x2 ----

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
from dataclasses import replace
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs.registry import get_smoke
from repro.launch.dryrun import _compile_once
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for tag, arch, shape_name, over in json.loads(sys.argv[1]):
    cell, rec = _compile_once(replace(get_smoke(arch), **over), shape_name,
                              mesh, None, True, False)
    out[tag] = {"argument_bytes": rec["memory"]["argument_bytes"],
                "model_flops": int(cell.model_flops_fn())}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    r = subprocess.run([sys.executable, "-c", REF, json.dumps(REF_CELLS)],
                       env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("tag,arch,shape_name,over", REF_CELLS,
                         ids=[c[0] for c in REF_CELLS])
def test_argument_bytes_and_model_flops_equal_the_reference(
        reference, tag, arch, shape_name, over):
    cfg = _cfg(get_smoke, arch, over)
    rec = dryrun.run_cell(arch, shape_name, MESH, save=False, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    want = reference[tag]
    assert rec["model_flops"] == want["model_flops"]
    got = rec["memory"]["argument_bytes"]
    assert rec["ranks"]["3"]["memory"]["argument_bytes"] == got
    if tag == "ferrari":
        # the reference holds the whole tables on every rank, the port
        # its 1/M of the rows
        tables = cfg.n_nodes * (2 * cfg.k_max + 4) * 4
        assert want["argument_bytes"] - got == tables - tables // 2
    else:
        assert got == want["argument_bytes"]


# ------------------------------------------- real steps on gloo ranks ----

RANK = r"""
import json, sys
from dataclasses import replace
import torch
import torch.distributed as dist
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
dist.init_process_group("gloo", rank=rank, world_size=4,
                        store=dist.FileStore(cfg["store"], 4))
from repro_torch.configs.base import shapes_for_family
from repro_torch.configs.registry import get_smoke
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.parallel import collectives

mesh = Mesh((2, 2), ("data", "model"), device="cpu")
out = {}
for tag, arch, shape_name, over, shape_over in cfg["cells"]:
    c = replace(get_smoke(arch), **over)
    shp = replace(shapes_for_family(c.family)[shape_name], **shape_over)
    cell = api.build_cell(c, shape_name, device="cpu", mesh=mesh,
                          shape_override=shp)
    gen = torch.Generator().manual_seed(0)
    if c.family == "ferrari":
        state = {k: torch.randint(0, 1 << 20, s, generator=gen, dtype=d)
                 for k, (s, d) in cell.state_shapes.items()}
    else:
        state = api.materialize_state(cell, c, shape_name, gen)
    batch = {}
    for k, (s, d) in cell.batch_shapes.items():
        if k == "pos":
            batch[k] = torch.tensor(shp.seq_len - 1, dtype=d)
        elif d.is_floating_point:
            batch[k] = (torch.ones(s) if k == "hist_mask"
                        else torch.rand(s, generator=gen))
        else:
            top = {"lm": getattr(c, "vocab", 1),
                   "gnn": getattr(shp, "n_classes", 1),
                   "recsys": getattr(c, "n_items", 1),
                   "ferrari": getattr(c, "n_nodes", 1)}[c.family]
            if k in ("src", "dst"):
                top = cell.batch_shapes["feats"][0][0]
            batch[k] = torch.randint(0, top, s, generator=gen, dtype=d)
    collectives.reset()
    cell.step(state, batch)
    out[tag] = {k: [collectives.KINDS[k], collectives.KIND_BYTES[k]]
                for k in collectives.KINDS}
Path = __import__("pathlib").Path
Path(cfg["out"] + f".{rank}.json").write_text(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_gloo")
    cfg = dict(store=str(tmp / "store"), out=str(tmp / "calls"),
               cells=GLOO_CELLS)
    procs = [subprocess.Popen([sys.executable, "-c", RANK, json.dumps(cfg),
                               str(r)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {r: json.loads(Path(f"{cfg['out']}.{r}.json").read_text())
            for r in range(4)}


@pytest.mark.parametrize("tag,arch,shape_name,over,shape_over", GLOO_CELLS,
                         ids=[c[0] for c in GLOO_CELLS])
def test_collectives_equal_a_real_gloo_step(gloo, tag, arch, shape_name,
                                            over, shape_over):
    cfg = _cfg(get_smoke, arch, over)
    shp = _shape(cfg, shape_name, shape_over)
    for rank in dryrun.ranks_of(MESH):
        _, fig = dryrun.dry_cell(cfg, shape_name, MESH, rank,
                                 shape_override=shp)
        got = {k: [v["count"], v["bytes"]]
               for k, v in fig["collectives"].items() if k != "total_bytes"}
        assert got == gloo[rank][tag], (rank, got, gloo[rank][tag])
        assert got                      # the cell does talk on 2x2


# ----------------------------------------- the production mesh, 16x16 ----

@pytest.mark.parametrize("arch,shape_name,kernels", [
    ("llama3-8b", "prefill_32k", {"flash_fwd": 32}),
    ("gin-tu", "molecule", {"batched_mp": 5, "batched_mp_bwd": 4}),
    ("mind", "retrieval_cand", {"retrieval_score": 1}),
    ("ferrari-web", "classify_16m", {"stab_packed_owned": 1})])
def test_published_cell_on_the_single_pod_mesh(arch, shape_name, kernels):
    before = dict(_lib.LAUNCHES)
    rec = dryrun.run_cell(arch, shape_name, "single", save=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["n_devices"] == 256 and set(rec["ranks"]) == {"0", "255"}
    for fig in rec["ranks"].values():
        assert {k: v["launches"] for k, v in fig["kernels"].items()} \
            == kernels
        assert fig["flops"] == fig["aten_flops"] + sum(
            v["flops"] for v in fig["kernels"].values())
        mem = fig["memory"]
        assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert rec["analysis"]["flops"] == rec["flops"]
    assert rec["model_flops"] > 0
    assert dict(_lib.LAUNCHES) == before      # nothing was launched
    assert not torch.distributed.is_initialized()


def test_op_profile_folds_the_layers():
    cfg = get_config("llama3-8b")
    full, mf = opprof.profile_cell("llama3-8b", "prefill_32k", "single",
                                   cfg=cfg)
    cut, _ = opprof.profile_cell("llama3-8b", "prefill_32k", "single",
                                 cfg=replace(cfg, n_layers=2))
    assert full["n_rows"] == cut["n_rows"] > 10
    assert full["flops_counts"]["kernel flash_fwd"] == 32
    assert cut["flops_counts"]["kernel flash_fwd"] == 2
    assert mf == cfg.active_param_count() * 2 * 32 * 32768 / 256
    # the kernels' operations are rows of their own, beside the aten ops
    assert full["total_dot_flops"] == full["aten_flops"] + 32 * work.work(
        "flash_fwd", (torch.empty(2, 32768, 2, 128, device="meta"),
                      torch.empty(2, 32768, 1, 128, device="meta"),
                      torch.empty(2, 32768, 1, 128, device="meta"), True,
                      0))[1]


# ---------------------------------------------------- the meta branch ----

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_record_meta_calls_and_launch_nothing():
    i32, bf16 = torch.int32, torch.bfloat16
    before = dict(_lib.LAUNCHES)
    work.TALLY.clear()
    v = st.stab_packed(_meta(64, 4, dtype=i32), _meta(64, 16, dtype=i32),
                       _meta(100, dtype=i32), _meta(100, dtype=i32))
    assert (v.shape, v.dtype, v.device.type) == ((100,), i32, "meta")
    v = st.stab_packed_owned(_meta(100, 4, dtype=i32),
                             _meta(32, 4, dtype=i32),
                             _meta(32, 16, dtype=i32), _meta(100, dtype=i32),
                             _meta(100, dtype=i32), 32)
    assert (v.shape, v.dtype) == ((100,), i32)
    q, k = _meta(2, 256, 8, 64, dtype=bf16), _meta(2, 256, 2, 64, dtype=bf16)
    out, lse = fa.flash_fwd(q, k, k)
    assert (out.shape, out.dtype, lse.shape, lse.dtype) == (
        q.shape, bf16, (2, 8, 256), torch.float32)
    dq, dk, dv = fa.flash_bwd(q, k, k, out, lse, q)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    with pytest.raises(ValueError, match="hd in"):
        fa.flash_fwd(_meta(1, 8, 2, 16), _meta(1, 8, 2, 16),
                     _meta(1, 8, 2, 16))
    adj, x, w = _meta(8, 30, 30), _meta(8, 30, 16), _meta(16, 64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = bm.batched_mp(adj, x, w)
    assert (y.shape, y.dtype) == ((8, 30, 64), torch.float32)
    y.sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    s = rs.retrieval_score(_meta(1000, 64), _meta(4, 64))
    assert s.shape == (1000,)
    assert {k: v["launches"] for k, v in work.TALLY.items()} == {
        "stab_packed": 1, "stab_packed_owned": 1, "flash_fwd": 1,
        "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "batched_mp": 1,
        "batched_mp_bwd": 1, "retrieval_score": 1}
    assert work.TALLY["flash_fwd"]["flops"] == 4 * 64 * 2 * 8 * (
        256 * 257 // 2)
    assert dict(_lib.LAUNCHES) == before


def test_meta_work_is_the_most_the_data_could_need():
    """On ``meta`` kernel 1 counts every query live and every id distinct
    (up to the table's rows): the work of such data on the CPU."""
    i32 = torch.int32
    n, q, k = 4096, 1000, 8
    meta, slab = torch.zeros(n, 4, dtype=i32), torch.zeros(n, 2 * k,
                                                           dtype=i32)
    cs = torch.arange(q, dtype=i32)
    ct = cs + q
    got = work.work("stab_packed", (meta.to("meta"), slab.to("meta"),
                                    cs.to("meta"), ct.to("meta")))
    assert got == work.work("stab_packed", (meta, slab, cs, ct))
    assert got > work.work("stab_packed", (meta, slab, cs, cs * 0))
    owned = (meta[:q], meta[:n // 2], slab[:n // 2], cs, ct, 0)
    assert work.work("stab_packed_owned", tuple(
        t.to("meta") if isinstance(t, torch.Tensor) else t
        for t in owned)) == work.work("stab_packed_owned", owned)


def test_meta_device_is_taken_by_name_only():
    from repro_torch.core.query_torch import resolve_device
    assert resolve_device("meta") == torch.device("meta")
    assert not st.on_cpu(_meta(1)) and st.is_meta(_meta(1))
    assert st.on_cpu(torch.empty(1)) and not st.is_meta(torch.empty(1))


def test_rules_override_the_placements():
    cfg = _cfg(get_smoke, "tinyllama-1.1b", LM_WIDE)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import api
    with dryrun.fake_world(4, 0):
        mesh = Mesh(*MESH, device="meta")
        plain = api.build_cell(cfg, "train_4k", device="meta", mesh=mesh)
        ruled = api.build_cell(cfg, "train_4k", device="meta", mesh=mesh,
                               rules={"mlp": None})
        spec = lambda c: c.state_shardings()["params"]["layers"][  # noqa
            "w_up"].spec
        assert "model" in str(spec(plain)) and spec(ruled) == (None,) * 3


def test_dry_run_leaves_the_counters_as_it_found_them():
    """A dry run counts its collectives and kernel calls on its own and
    gives the process's counters back as they were."""
    from repro_torch.parallel import collectives
    cfg = _cfg(get_smoke, "tinyllama-1.1b", LM_WIDE)
    shp = _shape(cfg, "prefill_32k", dict(batch=2, seq_len=16))
    collectives.CALLS["earlier"] = 1
    work.TALLY.add("retrieval_score", (_meta(10, 4), _meta(2, 4)))
    tally = {k: dict(v) for k, v in work.TALLY.items()}
    try:
        _, fig = dryrun.dry_cell(cfg, "prefill_32k", MESH, 0,
                                 shape_override=shp)
        assert fig["collectives"]["total_bytes"] > 0
        assert fig["kernels"]["flash_fwd"]["launches"] == cfg.n_layers
        assert dict(collectives.CALLS) == {"earlier": 1}
        assert not collectives.KINDS and not collectives.BYTES
        assert work.TALLY == tally
    finally:
        collectives.reset()
        work.TALLY.clear()
