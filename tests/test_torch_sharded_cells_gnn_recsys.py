"""The GNN, MIND and ferrari cells on a mesh in the port
(``models.api.build_cell(..., mesh=)``), the sharded segment reduction,
and train states saved and restored across meshes, on the CPU against
the reference.

The port's ranks are subprocesses of one gloo process group of four (a
FileStore under the test's temporary directory, no network); each mesh
lays out the first ranks it needs. The reference runs in subprocesses of
its own with ``--xla_force_host_platform_device_count=4``: one gives its
cells' ``state_shardings()`` and ``batch_shardings()`` on meshes 2x1,
1x2, 2x2 and (pod 2, data 1, model 2) for every GNN, MIND and ferrari
cell kind (for the sharded ferrari cell, the rows its step takes: its
``state_shardings()`` leave them replicated), its one-device steps on the same params and batches, and
``_sharded_segment_reduce`` on a 2x1 mesh (sum, whose ``jax.grad``
runs) and on one device (max: ``jax.grad`` of its ``pmax`` raises on
jax 0.9.0); the other restores the port's 2x2 checkpoints into its
cells on a 1x2 mesh.

At SMOKE widths: gin, gcn, sage and gatedgcn on full_graph, minibatch
and dense_batch at 2x1 and (2, 1, 2) (nodes and edges, or graphs, over
('pod', 'data')), one train step: loss, grad_norm and the state after it
gathered whole, against the reference's one-device step. The segment
reduction at data width 2 (2x1 and 2x2), sum and max, values drawn from
{0, 1, 2} so that maxima tie across ranks: every rank's rows and the
gradient of Σ rows·w assembled from the ranks' edge blocks, against the
reference. MIND: train at 1x2 and 2x2 (the table's rows over 'model'),
serve at 2x2, retrieval at 2x1 and 1x2 (a data rank's candidates).
Checkpoints: gin-tu's full-graph, MIND's and moonshot's MoE train states
drawn on 2x2, saved, restored at 1x2 (each rank its blocks under the
reference's 1x2 specs) and on one device, and by the reference into its
1x2 cells. At world 1 (a gloo group in this process) every GNN and MIND
cell equals the cell without a mesh bit for bit, with no collective.

Tolerances: a train step at the one-device GNN and MIND train tests'
(loss rtol 1e-5, grad_norm rtol 1e-4, params atol 2·lr, m and v rtol
1e-4 and atol 5e-4 × max|want|); segment sums and their gradients at
rtol 1e-5, atol 1e-6, maxima exactly (a tie's share of the gradient
is the cotangent over the tie count, which rounds in either order);
interests and scores at rtol 1e-5, atol 1e-6 × max|want|, the top 100
retrieved items equal; checkpoints bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as ref_get_smoke
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_rec
from repro_torch.checkpoint.checkpoint import (_flatten_with_paths,
                                               restore_like)
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.models import api
from repro_torch.optim.optimizer import OptConfig

pytestmark = pytest.mark.arch

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 300                 # seconds, each subprocess
WORLD = 4
OPT = dict(warmup_steps=2, total_steps=100)
GRAD_ATOL = 5e-4
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)     # atol times max|want|
SEG_TOL = dict(rtol=1e-5, atol=1e-6)
GNN_ARCHS = ("gin-tu", "gcn-cora", "graphsage-reddit", "gatedgcn")
# (kind, shape name, override)
GNN_KINDS = (("full_graph", "ogb_products",
              dict(n_nodes=700, n_edges=1500, d_feat=12, n_classes=4)),
             ("minibatch", "minibatch_lg",
              dict(batch_nodes=8, fanout=(3, 2), d_feat=12, n_classes=4)),
             ("dense_batch", "molecule",
              dict(batch_graphs=8, nodes_per_graph=6, d_feat=5,
                   n_classes=3)))
REC_KINDS = (("train", "train_batch", dict(batch=8)),
             ("serve", "serve_p99", dict(batch=8)),
             ("retrieval", "retrieval_cand", dict(n_candidates=1000)))
MESHES = (((2, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")))
SPEC_CASES = ([(a, k) for a in GNN_ARCHS for k, _, _ in GNN_KINDS]
              + [("mind", k) for k, _, _ in REC_KINDS]
              + [("ferrari-web", "classify")])
SPEC_IDS = [f"{a}-{k}-{'x'.join(map(str, s))}"
            for a, k in SPEC_CASES for s, _ in MESHES]
GNN_RUNS = [(a, k, m) for a in GNN_ARCHS for k, _, _ in GNN_KINDS
            for m in ((2, 1), (2, 1, 2))]
GNN_RUN_IDS = [f"{a}-{k}-{'x'.join(map(str, m))}" for a, k, m in GNN_RUNS]
REC_RUNS = [("train", (1, 2)), ("train", (2, 2)), ("serve", (2, 2)),
            ("retrieval", (2, 1)), ("retrieval", (1, 2))]
SEG = dict(m=64, n=16, d=3)   # messages, segments (nodes), width
CKPT = (("gin", "gin-tu", "full_graph"), ("mind", "mind", "train"),
        ("moe", "moonshot-v1-16b-a3b", "train"))

COMMON = r"""
import json, sys
from dataclasses import replace
import numpy as np
cfg = json.loads(sys.argv[1])
data = dict(np.load(cfg["data"]))
SHAPES = {k: (name, over) for k, name, over in cfg["gnn_kinds"]}
SHAPES.update({k: (name, over) for k, name, over in cfg["rec_kinds"]})
SHAPES["classify"] = ("classify_100k", {})

def fam(arch):
    return {"mind": "recsys", "ferrari-web": "ferrari"}.get(arch, "gnn")

def shape_of(shapes_for_family, arch, kind):
    name, over = SHAPES[kind]
    if kind == "train" and arch != "mind":     # the MoE LM's
        return "train_4k", replace(shapes_for_family("lm")["train_4k"],
                                   batch=8, seq_len=8)
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in over.items()}
    return name, replace(shapes_for_family(fam(arch))[name], **over)

def unflat(prefix, conv):
    tree = {}
    for k, v in data.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = conv(v)
    return listify(tree)

def listify(t):
    # the GNN's layers: a dict keyed 0, 1, ... back to a list
    if isinstance(t, dict):
        if t and all(k.isdigit() for k in t):
            return [listify(t[str(i)]) for i in range(len(t))]
        return {k: listify(v) for k, v in t.items()}
    return t
"""

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
""" + COMMON + r"""
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.checkpoint import checkpoint as ck
from repro.configs.base import shapes_for_family
from repro.configs.registry import get_smoke
from repro.models import gnn, recsys
from repro.models.api import build_cell
from repro.optim.optimizer import OptConfig, adamw_init
from repro.parallel.sharding import ShardingCtx, NO_SHARDING
specs, out = {}, {}

def spec_list(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

def meshes():
    for shape, axes in cfg["meshes"]:
        n = int(np.prod(shape))
        yield shape, Mesh(np.array(jax.devices()[:n]).reshape(shape),
                          tuple(axes))

for arch, kind in cfg["spec_cases"]:
    name, shp = shape_of(shapes_for_family, arch, kind)
    for shape, mesh in meshes():
        cell = build_cell(get_smoke(arch), name, mesh=mesh,
                          shape_override=shp)
        paths, leaves, _ = ck._flatten_with_paths(cell.state_shardings())
        tag = f"{arch}-{kind}-{'x'.join(map(str, shape))}"
        specs[tag] = {p: spec_list(s) for p, s in zip(paths, leaves)}
        specs[tag + "/batch"] = {k: spec_list(s) for k, s in
                                 cell.batch_shardings().items()}
        if arch == "ferrari-web":
            # the rows its sharded step takes (its shard_map's in_specs):
            # its CellSpec keeps the ctx without the rule
            from repro.parallel.sharding import logical_to_spec
            c = get_smoke(arch)
            sharded = (c.index_placement == "sharded"
                       and c.n_nodes % mesh.shape["model"] == 0)
            rules = {"index_nodes": "model"} if sharded else None
            specs[tag + "/step"] = {
                k: [list(e) if isinstance(e, tuple) else e for e in
                    logical_to_spec(cell.state_logical[k],
                                    cell.state_sds[k].shape, mesh, rules)]
                for k in cell.state_sds}

def batch_of(prefix):
    return {k[len(prefix):]: jnp.asarray(v) for k, v in data.items()
            if k.startswith(prefix)}

def train(arch, kind, tag):
    name, shp = shape_of(shapes_for_family, arch, kind)
    cell = build_cell(get_smoke(arch), name, shape_override=shp,
                      opt_cfg=OptConfig(**cfg["opt"]))
    params = unflat(tag + "/p/", jnp.asarray)
    st, m = jax.jit(cell.step)({"params": params, "opt": adamw_init(params)},
                               batch_of(tag + "/b/"))
    for k in ("loss", "grad_norm", "lr"):
        out[f"{tag}/{k}"] = np.asarray(m[k])
    paths, leaves, _ = ck._flatten_with_paths(st)
    for p, v in zip(paths, leaves):
        out[f"{tag}/state/{p}"] = np.asarray(v)

for arch in cfg["gnn_archs"]:
    for kind, _, _ in cfg["gnn_kinds"]:
        train(arch, kind, f"{arch}/{kind}")
train("mind", "train", "mind/train")
c = get_smoke("mind")
params = unflat("mind/train/p/", jnp.asarray)
b = batch_of("mind/serve/b/")
out["mind/serve/caps"] = np.asarray(recsys.serve_interests(
    c, params, b["hist_ids"], b["hist_mask"]))
b = batch_of("mind/retrieval/b/")
caps = recsys.serve_interests(c, params, b["hist_ids"], b["hist_mask"])
out["mind/retrieval/scores"] = np.asarray(recsys.retrieval_scores(
    c, params, caps[0], b["cand_ids"], use_pallas=False))

# the segment reduction: sum on a 2x1 mesh, max on one device
x, seg, w = (jnp.asarray(data["seg/" + k]) for k in ("x", "seg", "w"))
mesh = next(m for s, m in meshes() if list(s) == [2, 1])
for red, ctx in (("sum", ShardingCtx(mesh)), ("max", NO_SHARDING)):
    f = lambda x: gnn._sharded_segment_reduce(x, seg, cfg["seg"]["n"], ctx,
                                              red)
    out[f"seg/{red}/out"] = np.asarray(jax.jit(f)(x))
    out[f"seg/{red}/grad"] = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(f(x) * w)))(x))
try:
    jax.grad(lambda x: jnp.sum(gnn._sharded_segment_reduce(
        x, seg, cfg["seg"]["n"], ShardingCtx(mesh), "max") * w))(x)
    out["seg/max_mesh_grad"] = np.array("runs")
except NotImplementedError as e:
    out["seg/max_mesh_grad"] = np.array(str(e))
np.savez(cfg["out"], **out)
with open(cfg["specs"], "w") as f:
    json.dump(specs, f)
"""

REF_RESTORE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
""" + COMMON + r"""
import jax
from jax.sharding import Mesh
from repro.checkpoint import checkpoint as ck
from repro.configs.base import shapes_for_family
from repro.configs.registry import get_smoke
from repro.models.api import build_cell
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
out = {}
for key, arch, kind in cfg["ckpt_cases"]:
    c = get_smoke(arch)
    if c.family == "lm":
        c = replace(c, moe=replace(c.moe, impl="shard_map"))
    name, shp = shape_of(shapes_for_family, arch, kind)
    cell = build_cell(c, name, mesh=mesh, shape_override=shp)
    st, _ = ck.restore_checkpoint(cfg["ckpt"] + "/" + key, cell.state_sds,
                                  shardings=cell.state_shardings())
    paths, leaves, _ = ck._flatten_with_paths(st)
    for p, v in zip(paths, leaves):
        out[f"{key}/{p}"] = np.asarray(v)
np.savez(cfg["out"], **out)
"""

RANK = COMMON + r"""
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[2])
dist.init_process_group("gloo", rank=rank, world_size=cfg["world"],
                        store=dist.FileStore(cfg["store"], cfg["world"]))
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               _flatten_with_paths,
                                               gather_state)
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, gnn
from repro_torch.models.convert import params_from_arrays
from repro_torch.optim.optimizer import OptConfig, adamw_init
from repro_torch.parallel import CALLS, all_gather_
out = {}

def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))

def batch_of(prefix):
    return {k[len(prefix):]: t(v) for k, v in data.items()
            if k.startswith(prefix)}

meshes = {tuple(shape): Mesh(shape, axes, ranks=range(int(np.prod(shape))),
                             device="cpu")
          for shape, axes in cfg["meshes"]}
if rank == 0:
    for arch, kind in cfg["spec_cases"]:
        name, shp = shape_of(shapes_for_family, arch, kind)
        for shape, _ in cfg["meshes"]:
            cell = api.build_cell(get_smoke(arch), name,
                                  mesh=meshes[tuple(shape)],
                                  shape_override=shp)
            tag = f"{arch}-{kind}-{'x'.join(map(str, shape))}"
            out[tag + "/specs"] = np.array(json.dumps(
                {p: pl.spec for p, pl in
                 _flatten_with_paths(cell.state_shardings())}))
            out[tag + "/batch_specs"] = np.array(json.dumps(
                {k: p.spec for k, p in cell.batch_shardings().items()}))

def train(arch, kind, tag, mesh):
    name, shp = shape_of(shapes_for_family, arch, kind)
    fam_ = "recsys" if arch == "mind" else "gnn"
    cell = api.build_cell(get_smoke(arch), name, mesh=mesh,
                          shape_override=shp,
                          opt_cfg=OptConfig(**cfg["opt"]))
    params = params_from_arrays(fam_, unflat(tag + "/p/", np.asarray), "cpu")
    state = api.shard_state(cell, {"params": params,
                                   "opt": adamw_init(params)})
    CALLS.clear()
    state, m = cell.step(state, batch_of(tag + "/b/"))
    key = f"{tag}/{'x'.join(str(s) for s in mesh.shape)}"
    out[key + "/calls"] = np.array(json.dumps(dict(CALLS)))
    for k in ("loss", "grad_norm", "lr"):
        out[f"{key}/{k}"] = np.array(float(m[k]))
    for p, v in _flatten_with_paths(gather_state(state,
                                                 cell.state_shardings())):
        out[f"{key}/state/{p}"] = v.numpy()

for arch, kind, shape in cfg["gnn_runs"]:
    mesh = meshes[tuple(shape)]
    if mesh.member:
        train(arch, kind, f"{arch}/{kind}", mesh)

# the segment reduction at data width 2, each rank a block of the edges
for shape in ((2, 1), (2, 2)):
    mesh = meshes[shape]
    if not mesh.member:
        continue
    sc = cfg["seg"]
    i, grp, ranks = mesh.index("data"), mesh.group("data"), mesh.members(
        "data")
    e, r = sc["m"] // 2, sc["n"] // 2
    for red in ("sum", "max"):
        x = t(data["seg/x"][i * e:(i + 1) * e]).requires_grad_()
        rows = gnn.sharded_segment_reduce(
            x, t(data["seg/seg"][i * e:(i + 1) * e]), sc["n"], grp,
            (i * r, (i + 1) * r), red)
        (rows * t(data["seg/w"][i * r:(i + 1) * r])).sum().backward()
        tag = f"seg/{'x'.join(map(str, shape))}/{red}"
        out[tag + "/out"] = all_gather_(rows.detach(), grp, 0, ranks).numpy()
        out[tag + "/grad"] = all_gather_(x.grad, grp, 0, ranks).numpy()

for kind, shape in cfg["rec_runs"]:
    mesh = meshes[tuple(shape)]
    if not mesh.member:
        continue
    if kind == "train":
        train("mind", "train", "mind/train", mesh)
        continue
    name, shp = shape_of(shapes_for_family, "mind", kind)
    cell = api.build_cell(get_smoke("mind"), name, mesh=mesh,
                          shape_override=shp)
    params = params_from_arrays("recsys", unflat("mind/train/p/", np.asarray),
                                "cpu")
    CALLS.clear()
    _, res = cell.step(api.shard_state(cell, {"params": params}),
                       batch_of(f"mind/{kind}/b/"))
    key = f"mind/{kind}/{'x'.join(map(str, shape))}"
    out[key] = res.numpy()
    out[key + "/calls"] = np.array(json.dumps(dict(CALLS)))

# train states drawn on 2x2, saved; restored at 1x2
for key, arch, kind in cfg["ckpt_cases"]:
    c = get_smoke(arch)
    if c.family == "lm":
        c = replace(c, moe=replace(c.moe, impl="shard_map"))
    name, shp = shape_of(shapes_for_family, arch, kind)
    mesh = meshes[(2, 2)]
    cell = api.build_cell(c, name, mesh=mesh, shape_override=shp)
    state = api.materialize_state(cell, c, name,
                                  torch.Generator().manual_seed(5))
    CheckpointManager(cfg["ckpt"] + "/" + key, async_save=False).save(
        1, state, extra={"data_state": {"step": 1}}, mesh=mesh,
        placements=cell.state_shardings())
    dist.barrier()
    mesh = meshes[(1, 2)]
    if mesh.member:
        cell = api.build_cell(c, name, mesh=mesh, shape_override=shp)
        like = api.materialize_state(cell, c, name,
                                     torch.Generator().manual_seed(6))
        st, manifest = CheckpointManager(cfg["ckpt"] + "/" + key
                                         ).restore_latest(
            like, cell.state_shardings())
        out[f"ckpt/{key}/mesh"] = np.array(json.dumps(manifest["mesh"]))
        for p, v in _flatten_with_paths(st):
            out[f"ckpt/{key}/block/{p}"] = v.numpy()
        for p, v in _flatten_with_paths(gather_state(
                st, cell.state_shardings())):
            out[f"ckpt/{key}/whole/{p}"] = v.numpy()
np.savez(cfg["out"] % rank, **out)
dist.barrier()
dist.destroy_process_group()
"""


def _run(script, argv_cfg, n_procs=1):
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", script,
                               json.dumps(argv_cfg), str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n_procs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log


def _shape(arch, kind):
    name, over = {k: (n, o) for k, n, o in GNN_KINDS + REC_KINDS}[kind]
    family = "recsys" if arch == "mind" else "gnn"
    return name, dataclasses.replace(shapes_for_family(family)[name], **over)


def _gnn_batch(rng, cell, shape):
    """A batch of the cell's shapes: random features, edges over every
    node, labels with some unlabelled (-1) nodes."""
    out = {}
    for k, (s, dt) in cell.batch_shapes.items():
        if k in ("src", "dst"):
            n = cell.batch_shapes["feats"][0][0]
            out[k] = rng.integers(0, n, s).astype(np.int32)
        elif k == "labels":              # nodes may be unlabelled
            low = 0 if shape.kind == "dense_batch" else -1
            out[k] = rng.integers(low, shape.n_classes, s).astype(np.int32)
        elif k == "adj":
            a = (rng.random(s) < 0.4).astype(np.float32)
            out[k] = np.maximum(a, np.swapaxes(a, 1, 2))
        else:
            out[k] = rng.standard_normal(s).astype(np.float32)
    return out


def _rec_batch(rng, cfg, cell):
    out = {}
    for k, (s, dt) in cell.batch_shapes.items():
        if k == "hist_mask":
            out[k] = (rng.random(s) < 0.8).astype(np.float32)
            out[k][..., 0] = 1.0
        else:
            out[k] = rng.integers(0, cfg.n_items, s).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the reference's specs, steps, segment reductions and
    restores, and every port rank's outputs."""
    tmp = tmp_path_factory.mktemp("sharded_cells_gnn")
    rng = np.random.default_rng(0)
    data = {}
    for arch in GNN_ARCHS:
        rc = ref_get_smoke(arch)
        for kind, _, _ in GNN_KINDS:
            name, shp = _shape(arch, kind)
            p = jax.tree.map(np.asarray, ref_gnn.init_params(
                rc, jax.random.PRNGKey(2), shp.d_feat, shp.n_classes))
            for path, v in _flatten_with_paths(p):
                data[f"{arch}/{kind}/p/{path}"] = v
            cell = api.build_cell(get_smoke(arch), name, device="cpu",
                                  shape_override=shp)
            for k, v in _gnn_batch(rng, cell, shp).items():
                data[f"{arch}/{kind}/b/{k}"] = v
    p = jax.tree.map(np.asarray, ref_rec.init_params(
        ref_get_smoke("mind"), jax.random.PRNGKey(3)))
    for path, v in _flatten_with_paths(p):
        data[f"mind/train/p/{path}"] = v
    for kind, _, _ in REC_KINDS:
        name, shp = _shape("mind", kind)
        cell = api.build_cell(get_smoke("mind"), name, device="cpu",
                              shape_override=shp)
        for k, v in _rec_batch(rng, get_smoke("mind"), cell).items():
            data[f"mind/{kind}/b/{k}"] = v
    data["seg/x"] = rng.integers(0, 3, (SEG["m"], SEG["d"])).astype(
        np.float32)
    data["seg/seg"] = rng.integers(0, SEG["n"], SEG["m"]).astype(np.int32)
    data["seg/w"] = rng.standard_normal((SEG["n"], SEG["d"])).astype(
        np.float32)
    np.savez(tmp / "data.npz", **data)
    common = dict(
        data=str(tmp / "data.npz"), opt=OPT, seg=SEG,
        gnn_archs=list(GNN_ARCHS), gnn_kinds=[list(k) for k in GNN_KINDS],
        rec_kinds=[list(k) for k in REC_KINDS],
        meshes=[[list(s), list(a)] for s, a in MESHES],
        spec_cases=[list(c) for c in SPEC_CASES],
        gnn_runs=[[a, k, list(m)] for a, k, m in GNN_RUNS],
        rec_runs=[[k, list(m)] for k, m in REC_RUNS],
        ckpt_cases=[list(c) for c in CKPT], ckpt=str(tmp / "ckpt"))
    _run(REF, dict(common, out=str(tmp / "ref.npz"),
                   specs=str(tmp / "specs.json")))
    _run(RANK, dict(common, world=WORLD, store=str(tmp / "store"),
                    out=str(tmp / "rank%d.npz")), WORLD)
    _run(REF_RESTORE, dict(common, out=str(tmp / "ref_restore.npz")))
    return dict(data=data, ref=dict(np.load(tmp / "ref.npz")),
                specs=json.loads((tmp / "specs.json").read_text()),
                ranks=[dict(np.load(tmp / f"rank{r}.npz"))
                       for r in range(WORLD)],
                ref_restore=dict(np.load(tmp / "ref_restore.npz")), tmp=tmp)


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _step_close(rank_out, key, ref, rtag):
    np.testing.assert_allclose(rank_out[key + "/loss"], ref[rtag + "/loss"],
                               rtol=1e-5)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(rank_out[f"{key}/{k}"],
                                   ref[f"{rtag}/{k}"], rtol=1e-4, err_msg=k)
    lr = float(ref[rtag + "/lr"])
    names = [n for n in ref if n.startswith(rtag + "/state/")]
    assert names
    for name in names:
        path = name[len(rtag) + 7:]
        got, want = rank_out[f"{key}/state/{path}"], ref[name]
        if path.startswith("params/"):
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr,
                                       err_msg=path)
        elif path.startswith(("opt/m/", "opt/v/")):
            np.testing.assert_allclose(
                got, want, rtol=1e-4,
                atol=GRAD_ATOL * float(np.abs(want).max()), err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("tag", SPEC_IDS)
def test_specs_equal_the_reference(world, tag):
    """Every GNN, MIND and ferrari cell kind's state and batch placements
    on every mesh are the reference's (GNN params replicated, m and v
    under ZeRO-1, nodes and edges over ('pod', 'data'); the table's rows
    over 'model'; the sharded ferrari rows over 'model')."""
    r = world["ranks"][0]
    state_key = tag
    if tag.startswith("ferrari-web"):
        # the reference's sharded ferrari cell takes its rows over 'model'
        # in its step, while its state_shardings() keep them replicated
        # (ROADMAP, "Faults on the reference side"): the port's are the
        # step's
        state_key = tag + "/step"
        assert all(s == [None, None]
                   for s in world["specs"][tag].values()), tag
    for ref_key, port_key in ((state_key, tag + "/specs"),
                              (tag + "/batch", tag + "/batch_specs")):
        want = {p: _spec(s) for p, s in world["specs"][ref_key].items()}
        got = {p: _spec(s) for p, s in json.loads(str(r[port_key])).items()}
        assert got == want, port_key


@pytest.mark.parametrize("run", GNN_RUNS, ids=GNN_RUN_IDS)
def test_gnn_step_matches_the_reference(world, run):
    arch, kind, shape = run
    key = f"{arch}/{kind}/{'x'.join(map(str, shape))}"
    for r in world["ranks"][:int(np.prod(shape))]:
        _step_close(r, key, world["ref"], f"{arch}/{kind}")
    calls = json.loads(str(world["ranks"][0][key + "/calls"]))
    assert calls["grad_sum"] > 0
    if kind != "dense_batch":       # the segment sums, the node gathers
        assert calls["segment_sum"] > 0 and calls["gather_from_group"] > 0
    else:
        assert "segment_sum" not in calls


@pytest.mark.parametrize("shape", ((2, 1), (2, 2)), ids=("2x1", "2x2"))
@pytest.mark.parametrize("red", ("sum", "max"))
def test_sharded_segment_reduce_matches_the_reference(world, shape, red):
    """Each rank's rows, and the gradient from each rank's edge block,
    against the reference's (max: its one-device gradient, which splits a
    tie evenly; its own sharded max has no gradient rule)."""
    ref = world["ref"]
    tag = f"seg/{'x'.join(map(str, shape))}/{red}"
    r = world["ranks"][0]
    tol = SEG_TOL if red == "sum" else dict(rtol=0, atol=0)
    np.testing.assert_allclose(r[tag + "/out"], ref[f"seg/{red}/out"], **tol)
    np.testing.assert_allclose(r[tag + "/grad"], ref[f"seg/{red}/grad"],
                               **SEG_TOL)
    if red == "max":
        assert "pmax" in str(ref["seg/max_mesh_grad"])
        assert (ref["seg/max/grad"] % 1).any()    # a tie was split


@pytest.mark.parametrize("shape", ((1, 2), (2, 2)), ids=("1x2", "2x2"))
def test_mind_train_matches_the_reference(world, shape):
    key = f"mind/train/{'x'.join(map(str, shape))}"
    for r in world["ranks"][:int(np.prod(shape))]:
        _step_close(r, key, world["ref"], "mind/train")


def test_mind_serve_and_retrieval_match_the_reference(world):
    """Serve at 2x2 (interests of each data rank's users, the table's rows
    over 'model'), retrieval at 2x1 and 1x2 (a data rank's candidates,
    kernel 10's plain version here), gathered whole on every rank."""
    ref = world["ref"]
    want = ref["mind/serve/caps"]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["mind/serve/2x2"], want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))
    want = ref["mind/retrieval/scores"]
    for shape in ((2, 1), (1, 2)):
        for r in world["ranks"][:2]:
            got = r[f"mind/retrieval/{'x'.join(map(str, shape))}"]
            np.testing.assert_allclose(got, want, rtol=SCORE_TOL["rtol"],
                                       atol=SCORE_TOL["atol"]
                                       * float(np.abs(want).max()))
            assert np.array_equal(np.argsort(-got, kind="stable")[:100],
                                  np.argsort(-want, kind="stable")[:100])
    calls = json.loads(str(world["ranks"][0]["mind/retrieval/2x1/calls"]))
    assert calls == {"answers": 1}     # the scores, over the data ranks
    calls = json.loads(str(world["ranks"][0]["mind/retrieval/1x2/calls"]))
    assert calls["sum_over_group"] == 2   # history and candidate rows


@pytest.mark.parametrize("case", CKPT, ids=[c[0] for c in CKPT])
def test_checkpoint_crosses_meshes_and_packages(world, case):
    """A train state drawn and saved on 2x2 restores at 1x2 (each rank
    its blocks, gathered), on one device and into the reference's 1x2
    cell, every leaf bit for bit; the restored blocks are the blocks of
    the whole."""
    key, arch, kind = case
    c = get_smoke(arch)
    if c.family == "lm":
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, impl="shard_map"))
        name, shp = "train_4k", dataclasses.replace(
            shapes_for_family("lm")["train_4k"], batch=8, seq_len=8)
    else:
        name, shp = _shape(arch, kind)
    cell = api.build_cell(c, name, device="cpu", shape_override=shp)
    like = api.materialize_state(cell, c, name,
                                 torch.Generator().manual_seed(7))
    one, manifest = restore_like(world["tmp"] / "ckpt" / key, like)
    assert manifest["mesh"] == {"axis_names": ["data", "model"],
                                "shape": [2, 2]}
    rr = world["ref_restore"]
    for p, v in _flatten_with_paths(one):
        for r in world["ranks"][:2]:
            np.testing.assert_array_equal(r[f"ckpt/{key}/whole/{p}"],
                                          v.numpy(), err_msg=p)
        np.testing.assert_array_equal(rr[f"{key}/{p}"], v.numpy(),
                                      err_msg=p)
    leaf = {"gin": "layers/0/w_self", "mind": "table",
            "moe": "layers/wq"}[key]
    blocks = [world["ranks"][i][f"ckpt/{key}/block/params/{leaf}"]
              for i in range(2)]
    whole = dict(_flatten_with_paths(one))["params/" + leaf].numpy()
    if key == "gin":               # replicated: every rank the whole
        assert all(np.array_equal(b, whole) for b in blocks)
    else:                          # the table's rows, wq's heads: 'model'
        dim = 0 if key == "mind" else 2
        np.testing.assert_array_equal(np.concatenate(blocks, dim), whole)


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group in this process, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        yield make_debug_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", GNN_ARCHS + ("mind",))
def test_world_one_equals_no_mesh_bit_for_bit(group, arch):
    """At world 1 (mesh 1x1) every cell kind of the arch steps as the cell
    without a mesh, bit for bit, and makes no collective."""
    from repro_torch.parallel import CALLS
    cfg = get_smoke(arch)
    kinds = REC_KINDS if arch == "mind" else GNN_KINDS
    CALLS.clear()
    for kind, _, _ in kinds:
        name, shp = _shape(arch, kind)
        outs = []
        for mesh in (group, None):
            cell = api.build_cell(cfg, name, device="cpu", shape_override=shp,
                                  opt_cfg=OptConfig(**OPT), mesh=mesh)
            rng = np.random.default_rng(4)
            batch = (_rec_batch(rng, cfg, cell) if arch == "mind"
                     else _gnn_batch(rng, cell, shp))
            state = api.materialize_state(cell, cfg, name,
                                          torch.Generator().manual_seed(0))
            outs.append(cell.step(state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()}))
        for (p, x), (_, y) in zip(_flatten_with_paths(outs[0]),
                                  _flatten_with_paths(outs[1])):
            assert torch.equal(x, y), (kind, p)
    assert not CALLS
