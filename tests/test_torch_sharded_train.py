"""Sharded training of the dense LMs in the port (``launch.mesh.Mesh``,
``parallel.sharding``, ``transformer.TensorParallel``, the ZeRO-1 train
step of ``models.api``, checkpoints on a mesh) on the CPU, against the
port's one-device step and the reference's.

The port's ranks are subprocesses of one gloo process group of four (a
FileStore under the test's temporary directory, no network); each mesh
lays out the first ranks it needs, and the others take part only in
making its process groups. The reference runs in subprocesses of its own
that set ``--xla_force_host_platform_device_count`` before JAX loads:
one gives its train cell's ``state_shardings()`` specs on each mesh, its
one-device step on the same params and batch, and a checkpoint written
by its Trainer on a 2x2 mesh; the other restores the port's 2x2
checkpoint onto a 1x2 mesh.

At tinyllama-1.1b's SMOKE widths (8 heads over 2 kv heads) on meshes 2x1
(data parallel + ZeRO-1), 1x2 (tensor parallel), 2x2 and (pod 2, data 1,
model 2), and at smollm-360m's (3 heads over 1 kv head: heads padded to
4 and kv expanded at a model width of 2, its wq/wk/wv/wo blocks cut
inside a head and re-sliced over the model group) on 1x2, and on 1x4,
where the last model rank holds only a padded head, with 2
microbatches and remat: the specs equal the reference's; every rank's
drawn state is its block of the whole drawn from the same seed under the
reference's specs, bit for bit; one step's loss and grad_norm, and the
state after it assembled from the ranks' blocks under the reference's
specs, match the port's one-device step and the reference's step.
The batch's placements (``batch_shardings()``) are the reference's too.
Tolerances are the one-device train tests': loss rtol 1e-5, params atol
2·lr, m and v rtol 1e-4 and atol 5e-4 × max|want|. A checkpoint saved
at 2x2 restores at 1x2 and on one device, one written by the reference's
Trainer on its 2x2 mesh restores into the port's 1x2 cell, and the
reference restores the port's onto its 1x2 mesh. Dense prefill and
decode and a GNN cell build and step on the 1x2 mesh.
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
from repro.models import transformer as ref_tf
from repro_torch.checkpoint.checkpoint import (_flatten_with_paths,
                                               restore_like)
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.models import api
from repro_torch.models.convert import params_from_arrays
from repro_torch.optim.optimizer import OptConfig, adamw_init

pytestmark = pytest.mark.arch

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 300                 # seconds, each subprocess
WORLD = 4
OPT = dict(warmup_steps=2, total_steps=100)
TRAIN = dict(batch=8, seq=16, microbatches=2)
GRAD_ATOL = 5e-4
CASES = [("tinyllama-1.1b", (2, 1), ("data", "model")),
         ("tinyllama-1.1b", (1, 2), ("data", "model")),
         ("tinyllama-1.1b", (2, 2), ("data", "model")),
         ("tinyllama-1.1b", (2, 1, 2), ("pod", "data", "model")),
         ("smollm-360m", (1, 2), ("data", "model")),
         ("smollm-360m", (1, 4), ("data", "model"))]
IDS = [f"{a.split('-')[0]}-{'x'.join(map(str, s))}" for a, s, _ in CASES]

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from dataclasses import replace
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import checkpoint as ck
from repro.configs.base import shapes_for_family
from repro.configs.registry import get_smoke
from repro.models.api import build_cell
from repro.optim.optimizer import OptConfig, adamw_init
cfg = json.loads(sys.argv[1])
tr = cfg["train"]
shp = replace(shapes_for_family("lm")["train_4k"], batch=tr["batch"],
              seq_len=tr["seq"])
data = dict(np.load(cfg["data"]))
specs, out = {}, {}

def unflat(prefix):
    tree = {}
    for k, v in data.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return tree

for arch, shape, axes in cfg["cases"]:
    c = replace(get_smoke(arch), microbatches=tr["microbatches"], remat=True)
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(axes))
    cell = build_cell(c, "train_4k", mesh=mesh, shape_override=shp,
                      opt_cfg=OptConfig(**cfg["opt"]))
    paths, leaves, _ = ck._flatten_with_paths(cell.state_shardings())
    key = arch + "/" + "x".join(map(str, shape))
    specs[key] = {p: [list(e) if isinstance(e, tuple) else e for e in s.spec]
                  for p, s in zip(paths, leaves)}
    specs[key + "/batch"] = {
        k: [list(e) if isinstance(e, tuple) else e for e in s.spec]
        for k, s in cell.batch_shardings().items()}
for arch in sorted({a for a, _, _ in cfg["cases"]}):
    c = replace(get_smoke(arch), microbatches=tr["microbatches"], remat=True)
    cell = build_cell(c, "train_4k", shape_override=shp,
                      opt_cfg=OptConfig(**cfg["opt"]))
    params = unflat(arch + "/p/")
    state = {"params": params, "opt": adamw_init(params)}
    st, m = jax.jit(cell.step)(state, {"tokens": jnp.asarray(data["tokens"]),
                                       "labels": jnp.asarray(data["labels"])})
    for k in ("loss", "grad_norm", "lr"):
        out[f"{arch}/{k}"] = np.asarray(m[k])
    paths, leaves, _ = ck._flatten_with_paths(st)
    for p, v in zip(paths, leaves):
        out[f"{arch}/state/{p}"] = np.asarray(v)
np.savez(cfg["out"], **out)
with open(cfg["specs"], "w") as f:
    json.dump(specs, f)
# a checkpoint written by the reference's Trainer on a 2x2 mesh
from repro.launch.mesh import make_debug_mesh
from repro.launch.train import Trainer
t = Trainer("tinyllama-1.1b", smoke=True, ckpt_dir=cfg["ref_ckpt"],
            mesh=make_debug_mesh(4, model=2), batch_override=8,
            seq_override=16)
t.restore_or_init()
t.run(2, ckpt_every=2, log_every=100)
"""

REF_RESTORE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from dataclasses import replace
import jax, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import checkpoint as ck
from repro.configs.base import shapes_for_family
from repro.configs.registry import get_smoke
from repro.models.api import build_cell
cfg = json.loads(sys.argv[1])
tr = cfg["train"]
c = replace(get_smoke("tinyllama-1.1b"), microbatches=tr["microbatches"],
            remat=True)
shp = replace(shapes_for_family("lm")["train_4k"], batch=tr["batch"],
              seq_len=tr["seq"])
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
cell = build_cell(c, "train_4k", mesh=mesh, shape_override=shp)
st, manifest = ck.restore_checkpoint(cfg["ckpt"], cell.state_sds,
                                     shardings=cell.state_shardings())
paths, leaves, _ = ck._flatten_with_paths(st)
out = {p: np.asarray(v) for p, v in zip(paths, leaves)}
out["_mesh"] = np.array(json.dumps(manifest["mesh"]))
out["_n_devices"] = np.array(
    len(st["params"]["layers"]["wq"].sharding.device_set))
np.savez(cfg["out"], **out)
"""

RANK = r"""
import json, sys
from dataclasses import replace
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
dist.init_process_group("gloo", rank=rank, world_size=cfg["world"],
                        store=dist.FileStore(cfg["store"], cfg["world"]))
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               _flatten_with_paths, _tree_map)
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.models.convert import params_from_arrays
from repro_torch.optim.optimizer import OptConfig
from repro_torch.parallel import CALLS, sharding as shd
tr = cfg["train"]
lm = shapes_for_family("lm")
shp = replace(lm["train_4k"], batch=tr["batch"], seq_len=tr["seq"])
data = dict(np.load(cfg["data"]))
out = {}

def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))

def whole_params(arch):
    tree = {}
    for k, v in data.items():
        if k.startswith(arch + "/p/"):
            *path, leaf = k[len(arch) + 3:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return params_from_arrays("lm", tree, "cpu")

def blocks_of(tree, placements):
    where = dict(_flatten_with_paths(placements))
    paths = iter(p for p, _ in _flatten_with_paths(tree))
    def one(leaf):
        p = where[next(paths)]
        if leaf.dim() == 0:
            return leaf
        return shd.local_slice(leaf, p.spec, p.mesh).clone()
    return _tree_map(one, tree)

def record(prefix, state):
    for path, v in _flatten_with_paths(state):
        out[f"{prefix}/{path}"] = v.numpy().copy()

def cell_on(arch, mesh):
    c = replace(get_smoke(arch), microbatches=tr["microbatches"], remat=True)
    return c, api.build_cell(c, "train_4k", mesh=mesh, shape_override=shp,
                             opt_cfg=OptConfig(**cfg["opt"]))

meshes = {}
for arch, shape, axes in cfg["cases"]:
    key = arch + "/" + "x".join(map(str, shape))
    mesh = Mesh(shape, axes, ranks=range(int(np.prod(shape))), device="cpu")
    meshes[key] = mesh
    if not mesh.member:
        continue
    c, cell = cell_on(arch, mesh)
    pl = cell.state_shardings()
    out[key + "/specs"] = np.array(json.dumps(
        {p: pl_.spec for p, pl_ in _flatten_with_paths(pl)}))
    out[key + "/batch_specs"] = np.array(json.dumps(
        {k: p.spec for k, p in cell.batch_shardings().items()}))
    drawn = api.materialize_state(cell, c, "train_4k",
                                  torch.Generator().manual_seed(0))
    record(key + "/drawn", drawn)
    state = {"params": blocks_of(whole_params(arch), pl["params"]),
             "opt": drawn["opt"]}
    CALLS.clear()
    state, m = cell.step(state, {"tokens": t(data["tokens"]),
                                 "labels": t(data["labels"])})
    out[key + "/calls"] = np.array(json.dumps(dict(CALLS)))
    for k in ("loss", "grad_norm", "lr"):
        out[f"{key}/{k}"] = np.array(float(m[k]))
    record(key + "/state", state)
    if key == "tinyllama-1.1b/2x2":
        CheckpointManager(cfg["ckpt"], async_save=False).save(
            1, state, extra={"data_state": {"step": 1}}, mesh=mesh,
            placements=pl)
dist.barrier()
# restores at 1x2 (ranks 0 and 1): the port's 2x2 checkpoint, the
# reference's
mesh = Mesh((1, 2), ("data", "model"), device="cpu")
if mesh.member:
    c, cell = cell_on("tinyllama-1.1b", mesh)
    like = api.materialize_state(cell, c, "train_4k",
                                 torch.Generator().manual_seed(1))
    for name in ("ckpt", "ref_ckpt"):
        st, manifest = CheckpointManager(cfg[name]).restore_latest(
            like, cell.state_shardings())
        record("restore_" + name, st)
        out[f"restore_{name}/mesh"] = np.array(json.dumps(manifest["mesh"]))
    # the cells the dense train cell's mesh took first now take it too
    from repro_torch.configs import get_smoke as gs
    gen = torch.Generator().manual_seed(2)
    for cfg_, shape_name, over in (
            (c, "prefill_32k", dict(batch=2, seq_len=16)),
            (c, "decode_32k", dict(batch=2, seq_len=16)),
            (gs("gin-tu"), "molecule", dict(batch_graphs=4))):
        shp_ = replace(shapes_for_family(cfg_.family)[shape_name], **over)
        cell = api.build_cell(cfg_, shape_name, mesh=mesh,
                              shape_override=shp_)
        st = api.materialize_state(cell, cfg_, shape_name, gen)
        batch = {}
        for k, (s_, dt) in cell.batch_shapes.items():
            batch[k] = (torch.randint(0, 2, s_, generator=gen).to(dt)
                        if k != "pos" else torch.tensor(3, dtype=dt))
        CALLS.clear()
        _, res = cell.step(st, batch)
        res = res["logits"] if isinstance(res, dict) and "logits" in res \
            else res
        if isinstance(res, dict):
            res = res["loss"]
        out["stepped/" + shape_name] = res.numpy()
        out["stepped/" + shape_name + "/calls"] = np.array(
            sum(CALLS.values()))
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


def _cfg(arch):
    return dataclasses.replace(ref_get_smoke(arch),
                               microbatches=TRAIN["microbatches"], remat=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the reference's specs, step and checkpoint, every
    port rank's outputs, and the reference's restore of the port's
    checkpoint."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    data = {}
    for arch in sorted({a for a, _, _ in CASES}):
        p = jax.tree.map(np.asarray, ref_tf.init_params(
            _cfg(arch), jax.random.PRNGKey(0)))
        for path, v in _flatten_with_paths(p):
            data[f"{arch}/p/{path}"] = v
    rng = np.random.default_rng(0)
    vocab = min(get_smoke(a).vocab for a, _, _ in CASES)
    toks = rng.integers(0, vocab, (TRAIN["batch"], TRAIN["seq"] + 1))
    data["tokens"] = toks[:, :-1].astype(np.int32)
    data["labels"] = toks[:, 1:].astype(np.int32)
    np.savez(tmp / "data.npz", **data)
    cases = [[a, list(s), list(ax)] for a, s, ax in CASES]
    common = dict(data=str(tmp / "data.npz"), cases=cases, train=TRAIN,
                  opt=OPT, ckpt=str(tmp / "ckpt"),
                  ref_ckpt=str(tmp / "ref_ckpt"))
    _run(REF, dict(common, out=str(tmp / "ref.npz"),
                   specs=str(tmp / "specs.json")))
    _run(RANK, dict(common, world=WORLD, store=str(tmp / "store"),
                    out=str(tmp / "rank%d.npz")), WORLD)
    _run(REF_RESTORE, dict(common, out=str(tmp / "ref_restore.npz")))
    ref = dict(np.load(tmp / "ref.npz"))
    specs = json.loads((tmp / "specs.json").read_text())
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    ref_restore = dict(np.load(tmp / "ref_restore.npz"))
    return dict(data=data, ref=ref, specs=specs, ranks=ranks,
                ref_restore=ref_restore, tmp=tmp)


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _coords(shape, axes, rank):
    return dict(zip(axes, np.unravel_index(rank, shape)))


def _block(whole_shape, spec, sizes, coords):
    """This rank's slices of a leaf under ``spec`` (numpy, from the
    coordinates alone)."""
    idx = []
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + int(coords[a])
        b = whole_shape[dim] // n
        idx.append(slice(i * b, (i + 1) * b))
    return tuple(idx) + (slice(None),) * (len(whole_shape) - len(spec))


def _assemble(ranks, prefix, specs, shape, axes, whole_shapes):
    """The whole of every leaf from the ranks' blocks placed under the
    reference's ``specs``; ranks holding the same block must agree bit
    for bit."""
    sizes = dict(zip(axes, shape))
    out = {}
    for path, spec in specs.items():
        full = np.full(whole_shapes[path], np.nan, np.float64)
        for r in range(int(np.prod(shape))):
            got = ranks[r][f"{prefix}/{path}"]
            sl = _block(full.shape, _spec(spec), sizes,
                        _coords(shape, axes, r))
            part = full[sl]
            assert part.shape == got.shape, (path, r)
            if not np.isnan(part).all():
                np.testing.assert_array_equal(part, got, err_msg=path)
            full[sl] = got
        assert not np.isnan(full).any(), path
        out[path] = full
    return out


def _one_device(data, arch):
    """The port's one-device step on the same params and batch."""
    pcfg = dataclasses.replace(get_smoke(arch),
                               microbatches=TRAIN["microbatches"], remat=True)
    tree = {}
    for k, v in data.items():
        if k.startswith(arch + "/p/"):
            *path, leaf = k[len(arch) + 3:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    params = params_from_arrays("lm", tree, "cpu")
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"],
                              batch=TRAIN["batch"], seq_len=TRAIN["seq"])
    cell = api.build_cell(pcfg, "train_4k", device="cpu", shape_override=shp,
                          opt_cfg=OptConfig(**OPT))
    state, m = cell.step({"params": params, "opt": adamw_init(params)}, {
        "tokens": torch.from_numpy(data["tokens"]),
        "labels": torch.from_numpy(data["labels"])})
    return {p: v.numpy() for p, v in _flatten_with_paths(state)}, m


def _state_close(got, want, lr, what):
    for path, w in want.items():
        g = got[path]
        if path.startswith("params/"):
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr,
                                       err_msg=f"{what} {path}")
        elif path.startswith(("opt/m/", "opt/v/")):
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=GRAD_ATOL * float(np.abs(w).max()),
                err_msg=f"{what} {path}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_specs_equal_the_reference(world, case):
    arch, shape, axes = case
    key = arch + "/" + "x".join(map(str, shape))
    for ref_key, port_key in ((key, key + "/specs"),
                              (key + "/batch", key + "/batch_specs")):
        want = {p: _spec(s) for p, s in world["specs"][ref_key].items()}
        for r in range(int(np.prod(shape))):
            got = {p: _spec(s) for p, s in json.loads(
                str(world["ranks"][r][port_key])).items()}
            assert got == want, port_key


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_drawn_blocks_follow_the_reference_placement(world, case):
    """``materialize_state`` on the mesh: each rank's params are its block
    (under the reference's specs) of the whole drawn from the same seed
    on one device, bit for bit; m and v are zeros of their ZeRO-1
    blocks' shapes."""
    arch, shape, axes = case
    key = arch + "/" + "x".join(map(str, shape))
    pcfg = dataclasses.replace(get_smoke(arch),
                               microbatches=TRAIN["microbatches"], remat=True)
    cell = api.build_cell(pcfg, "train_4k", device="cpu")
    whole = dict(_flatten_with_paths(api.materialize_state(
        cell, pcfg, "train_4k", torch.Generator().manual_seed(0))))
    specs = world["specs"][key]
    sizes = dict(zip(axes, shape))
    for r in range(int(np.prod(shape))):
        coords = _coords(shape, axes, r)
        for path, spec in specs.items():
            got = world["ranks"][r][f"{key}/drawn/{path}"]
            w = whole[path].numpy()
            want = w[_block(w.shape, _spec(spec), sizes, coords)]
            if path.startswith("params/"):
                np.testing.assert_array_equal(got, want, err_msg=path)
            else:
                assert got.shape == want.shape and not got.any(), path


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_step_matches_one_device_and_reference(world, case):
    arch, shape, axes = case
    key = arch + "/" + "x".join(map(str, shape))
    mine, m = _one_device(world["data"], arch)
    ref = world["ref"]
    refs = {p[len(arch) + 7:]: v for p, v in ref.items()
            if p.startswith(arch + "/state/")}
    got = _assemble(world["ranks"], key + "/state", world["specs"][key],
                    shape, axes, {p: v.shape for p, v in mine.items()})
    lr = float(m["lr"])
    for r in range(int(np.prod(shape))):
        rk = world["ranks"][r]
        np.testing.assert_allclose(rk[key + "/loss"], float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(rk[key + "/loss"], ref[arch + "/loss"],
                                   rtol=1e-5)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(rk[f"{key}/{k}"], float(m[k]),
                                       rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(rk[f"{key}/{k}"], ref[f"{arch}/{k}"],
                                       rtol=1e-4, err_msg=k)
    _state_close(got, mine, lr, "vs the port's one-device step")
    _state_close(got, refs, lr, "vs the reference's step")
    calls = json.loads(str(world["ranks"][0][key + "/calls"]))
    M, n_dp = shape[-1], int(np.prod(shape[:-1]))
    assert (calls.get("sum_over_group", 0) > 0) == (M > 1)
    assert (calls.get("zero1_gather", 0) > 0) == (n_dp > 1)
    assert ("gather_from_group" in calls) == (arch == "smollm-360m")


def test_checkpoint_crosses_meshes_and_packages(world):
    """The port's 2x2 checkpoint (whole leaves, its mesh in the manifest)
    restores at 1x2, each rank its blocks, and on one device; the
    reference's 2x2 Trainer's restores at 1x2; the reference restores the
    port's onto its 1x2 mesh."""
    tmp, ranks = world["tmp"], world["ranks"]
    key = "tinyllama-1.1b/2x2"
    shape, axes = (2, 2), ("data", "model")
    pcfg = dataclasses.replace(get_smoke("tinyllama-1.1b"),
                               microbatches=TRAIN["microbatches"], remat=True)
    cell = api.build_cell(pcfg, "train_4k", device="cpu")
    like = api.materialize_state(cell, pcfg, "train_4k",
                                 torch.Generator().manual_seed(1))
    whole_shapes = {p: tuple(v.shape) for p, v in _flatten_with_paths(like)}
    saved = _assemble(ranks, key + "/state", world["specs"][key], shape,
                      axes, whole_shapes)
    one, manifest = restore_like(tmp / "ckpt", like)
    assert manifest["mesh"] == {"axis_names": ["data", "model"],
                                "shape": [2, 2]}
    for p, v in _flatten_with_paths(one):
        np.testing.assert_array_equal(v.numpy(), saved[p], err_msg=p)
    # at 1x2: each rank's blocks under the reference's 1x2 specs
    specs12 = world["specs"]["tinyllama-1.1b/1x2"]
    got = _assemble(ranks, "restore_ckpt", specs12, (1, 2), axes,
                    whole_shapes)
    for p in saved:
        np.testing.assert_array_equal(got[p], saved[p], err_msg=p)
    ref_whole, ref_manifest = restore_like(tmp / "ref_ckpt", like)
    assert ref_manifest["mesh"] == {"axis_names": ["data", "model"],
                                    "shape": [2, 2]}
    got = _assemble(ranks, "restore_ref_ckpt", specs12, (1, 2), axes,
                    whole_shapes)
    for p, v in _flatten_with_paths(ref_whole):
        np.testing.assert_array_equal(got[p], v.numpy(), err_msg=p)
    rr = world["ref_restore"]
    assert json.loads(str(rr["_mesh"])) == manifest["mesh"]
    assert int(rr["_n_devices"]) == 2
    for p in saved:
        np.testing.assert_array_equal(rr[p], saved[p], err_msg=p)


def test_world_one_mesh_equals_no_mesh_bit_for_bit(tmp_path):
    """A world-1 gloo group in this process (mesh 1x1): the Trainer on the
    mesh trains as the Trainer without one, losses and every leaf bit for
    bit, launching no collective."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.parallel import CALLS
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        runs = []
        CALLS.clear()
        for mesh in (make_debug_mesh(device="cpu"), None):
            tr = Trainer("tinyllama-1.1b", smoke=True, device="cpu",
                         mesh=mesh, batch_override=8, seq_override=16)
            tr.run(2, log_every=100)
            runs.append(tr)
        a, b = runs
        assert [h["loss"] for h in a.history] == \
            [h["loss"] for h in b.history]
        for (p, x), (_, y) in zip(_flatten_with_paths(a.state),
                                  _flatten_with_paths(b.state)):
            assert torch.equal(x, y), p
        assert not CALLS
    finally:
        dist.destroy_process_group()


def test_other_cells_build_and_step_on_a_mesh(world):
    """The dense prefill and decode cells and a GNN cell build and step
    on the 1x2 mesh: finite answers, the same on both ranks, made with
    collectives (``tests/test_torch_sharded_cells_*.py`` hold them
    against the reference)."""
    for name in ("prefill_32k", "decode_32k", "molecule"):
        got = [world["ranks"][r]["stepped/" + name] for r in (0, 1)]
        assert np.isfinite(got[0]).all(), name
        np.testing.assert_array_equal(got[0], got[1], err_msg=name)
        if name != "molecule":      # the GNN's params are replicated
            assert int(world["ranks"][0][f"stepped/{name}/calls"]) > 0
