"""The LM cells on a mesh in the port (``models.api.build_cell(...,
mesh=)``): tensor-parallel prefill, flash-decoding over the cache's
sequence, and the MoE cells with attention over 'model', on the CPU
against the reference.

The port's ranks are subprocesses of one gloo process group of four (a
FileStore under the test's temporary directory, no network); each mesh
lays out the first ranks it needs. The reference runs in a subprocess of
its own with ``--xla_force_host_platform_device_count=4``: its cells'
``state_shardings()`` and ``batch_shardings()`` on meshes 2x1, 1x2, 2x2
and (pod 2, data 1, model 2) for the train, prefill and decode kinds
(decode at batch 1, where the cache's sequence takes ('data', 'model'),
and at batch 2, where the batch takes 'data' and the sequence 'model'),
of tinyllama-1.1b, smollm-360m (3 heads, padded to 4 over 2 model
ranks), tinyllama with the int8 cache and moonshot-v1-16b-a3b (MoE,
``impl="shard_map"``); its one-device prefill and decode; and its MoE
train step on a 1x2 mesh (``jax.grad`` of its cell).

At SMOKE widths, on meshes 1x2 and 2x2 and at batch 1 and 2: the prefill
cell's logits (gathered over 'model') and its cache (each rank's block,
assembled under the reference's cache spec) against the reference's
one-device ``prefill`` of the whole prompt; the decode cell from the
reference's prefill cache of the first 12 tokens, cut to each rank's
block, 4 steps: every step's logits and the cache after them, assembled,
against the reference's ``decode_step``; the int8 cache (tinyllama) at
both batches on 2x2; and at 2x2 with a cache of 18 positions, which
the 4 ranks do not divide, so that its sequence takes 'data' alone and
its kv heads 'model' (dense and int8). The MoE prefill cell and train step (2
microbatches) at 1x2, the state gathered whole, against the reference's;
the train step with the gather dispatch against the port's one-device
step. ``Trainer(mesh=)`` with the MoE arch at world 1.
At world 1 (a gloo group in this process, mesh 1x1) every LM cell kind
equals the cell without a mesh bit for bit and launches no collective.

Tolerances: logits at rtol 1e-4 and atol 1e-5 × their largest magnitude
(the one-device LM tests'); float caches at rtol 1e-4, atol 1e-5; int8
cache values within one quantum (a rounding tie can flip where the
flash-decoding's sums round differently) and their scales at rtol 1e-5;
the MoE train step at the one-device train tests' (loss rtol 1e-5,
grad_norm rtol 1e-4, params atol 2·lr, m and v rtol 1e-4 and atol 5e-4
× max|want|).
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
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.models import api
from repro_torch.models.convert import params_from_arrays
from repro_torch.optim.optimizer import OptConfig

pytestmark = pytest.mark.arch

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 300                 # seconds, each subprocess
WORLD = 4
SEQ, PROMPT, STEPS = 16, 12, 4
OPT = dict(warmup_steps=2, total_steps=100)
TRAIN = dict(batch=8, seq=16, microbatches=2)
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5       # atol times max|want|
CACHE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_ATOL = 5e-4
MOE = "moonshot-v1-16b-a3b"
# (key, arch, int8 cache)
ARCHS = (("tinyllama", "tinyllama-1.1b", False),
         ("smollm", "smollm-360m", False),
         ("int8", "tinyllama-1.1b", True),
         ("moe", MOE, False))
MESHES = (((2, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")))
# (name, kind, shape override)
KINDS = (("train", "train_4k", dict(batch=8, seq_len=16)),
         ("prefill", "prefill_32k", dict(batch=2, seq_len=16)),
         ("decode1", "decode_32k", dict(batch=1, seq_len=16)),
         ("decode2", "decode_32k", dict(batch=2, seq_len=16)))
# the runs on the gloo ranks: (arch key, mesh, batch)
# (arch key, mesh, batch, max_seq): at 18 the cache's sequence takes
# 'data' alone and its kv heads 'model'
RUNS = ([(a, m, b, SEQ) for a in ("tinyllama", "smollm")
         for m in ((1, 2), (2, 2)) for b in (1, 2)]
        + [("int8", (2, 2), b, SEQ) for b in (1, 2)]
        + [("tinyllama", (2, 2), 1, 18), ("int8", (2, 2), 1, 18)])
SPEC_IDS = [f"{a}-{k}-{'x'.join(map(str, s))}"
            for a, _, _ in ARCHS for k, _, _ in KINDS for s, _ in MESHES]
RUN_IDS = [f"{a}-{'x'.join(map(str, m))}-b{b}-s{n}" for a, m, b, n in RUNS]

COMMON = r"""
import json, sys
from dataclasses import replace
import numpy as np
cfg = json.loads(sys.argv[1])
data = dict(np.load(cfg["data"]))

def cfg_of(get_smoke, key):
    arch, int8 = {a[0]: (a[1], a[2]) for a in cfg["archs"]}[key]
    c = get_smoke(arch)
    if int8:
        c = replace(c, kv_cache_dtype="int8")
    if c.moe is not None:
        c = replace(c, moe=replace(c.moe, capacity_factor=8.0,
                                   dispatch="sort", impl="shard_map"))
    return replace(c, microbatches=cfg["train"]["microbatches"])

def unflat(prefix, conv):
    tree = {}
    for k, v in data.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = conv(v)
    return tree
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
from repro.models import transformer as tf
from repro.models.api import build_cell
from repro.optim.optimizer import OptConfig, adamw_init
lm = shapes_for_family("lm")
specs, out = {}, {}

def spec_list(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

for key, _, _ in cfg["archs"]:
    c = cfg_of(get_smoke, key)
    for kname, shape_name, over in cfg["kinds"]:
        shp = replace(lm[shape_name], **over)
        for shape, axes in cfg["meshes"]:
            n = int(np.prod(shape))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                        tuple(axes))
            cell = build_cell(c, shape_name, mesh=mesh, shape_override=shp)
            paths, leaves, _ = ck._flatten_with_paths(cell.state_shardings())
            tag = f"{key}-{kname}-{'x'.join(map(str, shape))}"
            specs[tag] = {p: spec_list(s) for p, s in zip(paths, leaves)}
            specs[tag + "/batch"] = {k: spec_list(s) for k, s in
                                     cell.batch_shardings().items()}

def quantize_all(x):
    s = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
                    / 127.0, 1e-8)
    return (jnp.clip(jnp.round(x.astype(jnp.float32) / s[..., None]),
                     -127, 127).astype(jnp.int8), s)

P = cfg["prompt"]
for key, b, S in sorted({(k, b, n) for k, _, b, n in cfg["runs"]}):
    c = cfg_of(get_smoke, key)
    params = unflat(key + "/p/", jnp.asarray)
    toks = jnp.asarray(data["prompt"][:b, :S])
    tag = f"{key}/b{b}/s{S}"
    if key != "int8":
        logits, cache = jax.jit(lambda p, t: tf.prefill(c, p, t, S))(
            params, toks)
        out[tag + "/prefill/logits"] = np.asarray(logits)
        for k, v in cache.items():
            out[tag + "/prefill/cache/" + k] = np.asarray(v)
    _, cache = jax.jit(lambda p, t: tf.prefill(c, p, t, S))(
        params, toks[:, :P])
    if c.kv_cache_dtype == "int8":
        (kq, ks), (vq, vs) = quantize_all(cache["k"]), quantize_all(
            cache["v"])
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for k, v in cache.items():
        out[tag + "/start/" + k] = np.asarray(v)
    step = jax.jit(lambda p, ca, t, pos: tf.decode_step(c, p, ca, t, pos))
    for i in range(S - P):
        logits, cache = step(params, cache, toks[:, P + i:P + i + 1],
                             jnp.int32(P + i))
        out[f"{tag}/decode/logits{i}"] = np.asarray(logits)
    for k, v in cache.items():
        out[tag + "/decode/cache/" + k] = np.asarray(v)

# the MoE prefill (one device) and train step (jax.grad of the cell on a
# 1x2 mesh)
c = cfg_of(get_smoke, "moe")
params = unflat("moe/p/", jnp.asarray)
S = cfg["seq"]
logits, cache = jax.jit(lambda p, t: tf.prefill(c, p, t, S))(
    params, jnp.asarray(data["prompt"][:, :S]))
out["moe/prefill/logits"] = np.asarray(logits)
out["moe/prefill/cache/k"] = np.asarray(cache["k"])
tr = cfg["train"]
shp = replace(lm["train_4k"], batch=tr["batch"], seq_len=tr["seq"])
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
cell = build_cell(c, "train_4k", mesh=mesh, shape_override=shp,
                  opt_cfg=OptConfig(**cfg["opt"]))
state = {"params": params, "opt": adamw_init(params)}
st, m = jax.jit(cell.step)(state, {"tokens": jnp.asarray(data["tokens"]),
                                   "labels": jnp.asarray(data["labels"])})
for k in ("loss", "grad_norm", "lr"):
    out["moe/train/" + k] = np.asarray(m[k])
paths, leaves, _ = ck._flatten_with_paths(st)
for p, v in zip(paths, leaves):
    out["moe/train/state/" + p] = np.asarray(v)
np.savez(cfg["out"], **out)
with open(cfg["specs"], "w") as f:
    json.dump(specs, f)
"""

RANK = COMMON + r"""
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[2])
dist.init_process_group("gloo", rank=rank, world_size=cfg["world"],
                        store=dist.FileStore(cfg["store"], cfg["world"]))
from repro_torch.checkpoint.checkpoint import _flatten_with_paths, gather_state
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_arrays
from repro_torch.optim.optimizer import OptConfig, adamw_init
from repro_torch.parallel import CALLS, sharding as shd
lm = shapes_for_family("lm")
ref = dict(np.load(cfg["ref"]))
out = {}
P = cfg["prompt"]

def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))

def whole_cache(c, cache, shape, mesh):
    # the whole of a cache from every rank's block (its spec's)
    out = {}
    for k, v in cache.items():
        spec = shd.logical_to_spec(tf.cache_logical_axes(c)[k],
                                   tf.cache_shapes(c, *shape)[k], mesh)
        out[k] = shd.gather(v, spec, mesh)
    return out

meshes = {}
for shape, axes in cfg["meshes"]:
    meshes[tuple(shape)] = Mesh(shape, axes, ranks=range(int(np.prod(shape))),
                                device="cpu")
# the port's specs (rank 0: building a cell makes no collective)
if rank == 0:
    for key, _, _ in cfg["archs"]:
        c = cfg_of(get_smoke, key)
        for kname, shape_name, over in cfg["kinds"]:
            shp = replace(lm[shape_name], **over)
            for shape, _ in cfg["meshes"]:
                cell = api.build_cell(c, shape_name, mesh=meshes[tuple(shape)],
                                      shape_override=shp)
                tag = f"{key}-{kname}-{'x'.join(map(str, shape))}"
                out[tag + "/specs"] = np.array(json.dumps(
                    {p: pl.spec for p, pl in
                     _flatten_with_paths(cell.state_shardings())}))
                out[tag + "/batch_specs"] = np.array(json.dumps(
                    {k: p.spec for k, p in cell.batch_shardings().items()}))

for key, shape, b, S in cfg["runs"]:
    mesh = meshes[tuple(shape)]
    tag = f"{key}/{'x'.join(map(str, shape))}/b{b}/s{S}"
    if not mesh.member:
        continue
    c = cfg_of(get_smoke, key)
    params = params_from_arrays("lm", unflat(key + "/p/", np.asarray), "cpu")
    toks = t(data["prompt"][:b, :S])
    CALLS.clear()
    if key != "int8":
        cell = api.build_cell(c, "prefill_32k", mesh=mesh, shape_override=
                              replace(lm["prefill_32k"], batch=b, seq_len=S))
        _, res = cell.step(api.shard_state(cell, {"params": params}),
                           {"tokens": toks})
        out[tag + "/prefill/logits"] = res["logits"].numpy()
        for k, v in whole_cache(c, res["cache"], (b, S), mesh).items():
            out[tag + "/prefill/cache/" + k] = v.numpy()
    cell = api.build_cell(c, "decode_32k", mesh=mesh, shape_override=
                          replace(lm["decode_32k"], batch=b, seq_len=S))
    start = {k: t(ref[f"{key}/b{b}/s{S}/start/{k}"]) for k in
             tf.cache_logical_axes(c)}
    state = api.shard_state(cell, {"params": params, "cache": start})
    for i in range(S - P):
        state, logits = cell.step(state, {
            "token": toks[:, P + i:P + i + 1],
            "pos": torch.tensor(P + i, dtype=torch.int32)})
        out[f"{tag}/decode/logits{i}"] = logits.numpy()
    whole = gather_state(state, cell.state_shardings())
    for k, v in whole["cache"].items():
        out[tag + "/decode/cache/" + k] = v.numpy()
    out[tag + "/calls"] = np.array(json.dumps(dict(CALLS)))

# the MoE prefill and train step at 1x2, attention over 'model'
mesh = meshes[(1, 2)]
if mesh.member:
    c = cfg_of(get_smoke, "moe")
    params = params_from_arrays("lm", unflat("moe/p/", np.asarray), "cpu")
    S = cfg["seq"]
    cell = api.build_cell(c, "prefill_32k", mesh=mesh, shape_override=replace(
        lm["prefill_32k"], batch=2, seq_len=S))
    CALLS.clear()
    _, res = cell.step(api.shard_state(cell, {"params": params}),
                       {"tokens": t(data["prompt"][:, :S])})
    out["moe/prefill/logits"] = res["logits"].numpy()
    out["moe/prefill/cache/k"] = whole_cache(c, res["cache"], (2, S),
                                             mesh)["k"].numpy()
    out["moe/prefill/calls"] = np.array(json.dumps(dict(CALLS)))
    tr = cfg["train"]
    cell = api.build_cell(c, "train_4k", mesh=mesh, shape_override=replace(
        lm["train_4k"], batch=tr["batch"], seq_len=tr["seq"]),
        opt_cfg=OptConfig(**cfg["opt"]))
    state = api.shard_state(cell, {"params": params,
                                   "opt": adamw_init(params)})
    state, m = cell.step(state, {"tokens": t(data["tokens"]),
                                 "labels": t(data["labels"])})
    for k in ("loss", "grad_norm", "lr"):
        out["moe/train/" + k] = np.array(float(m[k]))
    for p, v in _flatten_with_paths(gather_state(state,
                                                 cell.state_shardings())):
        out["moe/train/state/" + p] = v.numpy()
    # the gather dispatch: every rank of the model group runs the whole
    # FFN from the gathered stacks
    g = replace(c, moe=replace(c.moe, impl="gather"))
    params = params_from_arrays("lm", unflat("moe/p/", np.asarray), "cpu")
    cell = api.build_cell(g, "train_4k", mesh=mesh, shape_override=replace(
        lm["train_4k"], batch=tr["batch"], seq_len=tr["seq"]),
        opt_cfg=OptConfig(**cfg["opt"]))
    state = api.shard_state(cell, {"params": params,
                                   "opt": adamw_init(params)})
    state, m = cell.step(state, {"tokens": t(data["tokens"]),
                                 "labels": t(data["labels"])})
    for k in ("loss", "grad_norm", "lr"):
        out["moe_gather/train/" + k] = np.array(float(m[k]))
    for p, v in _flatten_with_paths(gather_state(state,
                                                 cell.state_shardings())):
        out["moe_gather/train/state/" + p] = v.numpy()
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


def _ref_cfg(key):
    arch, int8 = {a[0]: (a[1], a[2]) for a in ARCHS}[key]
    c = ref_get_smoke(arch)
    return dataclasses.replace(c, kv_cache_dtype="int8") if int8 else c


def _port_cfg(key):
    arch, int8 = {a[0]: (a[1], a[2]) for a in ARCHS}[key]
    c = get_smoke(arch)
    if int8:
        c = dataclasses.replace(c, kv_cache_dtype="int8")
    if c.moe is not None:
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0, dispatch="sort", impl="shard_map"))
    return dataclasses.replace(c, microbatches=TRAIN["microbatches"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the reference's specs and answers, and every port
    rank's outputs."""
    tmp = tmp_path_factory.mktemp("sharded_cells_lm")
    data = {}
    for key in ("tinyllama", "smollm", "int8", "moe"):
        p = jax.tree.map(np.asarray, ref_tf.init_params(
            _ref_cfg(key), jax.random.PRNGKey(1)))
        for path, v in _flatten_with_paths(p):
            data[f"{key}/p/{path}"] = v
    rng = np.random.default_rng(0)
    data["prompt"] = rng.integers(0, 512, (2, 18)).astype(np.int32)
    toks = rng.integers(0, 512, (TRAIN["batch"], TRAIN["seq"] + 1))
    data["tokens"] = toks[:, :-1].astype(np.int32)
    data["labels"] = toks[:, 1:].astype(np.int32)
    np.savez(tmp / "data.npz", **data)
    common = dict(data=str(tmp / "data.npz"), archs=[list(a) for a in ARCHS],
                  kinds=[list(k) for k in KINDS],
                  meshes=[[list(s), list(a)] for s, a in MESHES],
                  runs=[[a, list(m), b, n] for a, m, b, n in RUNS],
                  seq=SEQ,
                  prompt=PROMPT, steps=STEPS, train=TRAIN, opt=OPT)
    _run(REF, dict(common, out=str(tmp / "ref.npz"),
                   specs=str(tmp / "specs.json")))
    _run(RANK, dict(common, world=WORLD, store=str(tmp / "store"),
                    ref=str(tmp / "ref.npz"), out=str(tmp / "rank%d.npz")),
         WORLD)
    return dict(data=data, ref=dict(np.load(tmp / "ref.npz")),
                specs=json.loads((tmp / "specs.json").read_text()),
                ranks=[dict(np.load(tmp / f"rank{r}.npz"))
                       for r in range(WORLD)])


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _logits_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * float(np.abs(want).max()),
                               err_msg=what)


def _cache_close(got, want, what):
    if want.dtype == np.int8:
        assert np.abs(got.astype(np.int32) - want).max() <= 1, what
    elif what.endswith("scale"):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **CACHE_TOL, err_msg=what)


@pytest.mark.parametrize("tag", SPEC_IDS)
def test_specs_equal_the_reference(world, tag):
    """Every LM cell kind's state and batch placements on every mesh are
    the reference's (the decode cache and its int8 scales, the MoE
    decode's experts' mlp dim over 'data')."""
    r = world["ranks"][0]
    for ref_key, port_key in ((tag, tag + "/specs"),
                              (tag + "/batch", tag + "/batch_specs")):
        want = {p: _spec(s) for p, s in world["specs"][ref_key].items()}
        got = {p: _spec(s) for p, s in json.loads(str(r[port_key])).items()}
        assert got == want, port_key


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_prefill_and_decode_match_the_reference(world, run):
    """Every rank's logits, and the caches assembled from the ranks'
    blocks, against the reference's one-device prefill and decode."""
    key, shape, b, seq = run
    tag = f"{key}/{'x'.join(map(str, shape))}/b{b}/s{seq}"
    ref = world["ref"]
    for r in world["ranks"][:int(np.prod(shape))]:
        names = [n for n in r if n.startswith(tag + "/") and
                 not n.endswith("/calls")]
        assert names, tag
        for name in names:
            want = ref[f"{key}/b{b}/s{seq}/" + name[len(tag) + 1:]]
            if "logits" in name:
                _logits_close(r[name], want, name)
            else:
                _cache_close(r[name], want, name)
    calls = json.loads(str(world["ranks"][0][tag + "/calls"]))
    # q, k and v made whole from the column blocks of wq, wk, wv over
    # 'model' (every head on every rank), a layer and step; wk and wv
    # gathered whole for the prefill's cache, a layer; the partial
    # softmaxes' max and sums over the cache's sequence group
    n_layers, steps = _port_cfg(key).n_layers, seq - PROMPT
    assert calls["columns"] == 3 * n_layers * steps
    assert calls.get("weight_gather", 0) == (2 * n_layers if key != "int8"
                                             else 0)
    assert calls.get("decode_max", 0) == calls.get("decode_sum", 0) > 0
    # the batch rows' outputs gathered where the batch is split (2x2, b 2),
    # the heads' where the kv heads are
    assert ("decode_rows" in calls) == (shape == (2, 2) and b == 2)
    assert ("decode_heads" in calls) == (seq == 18)


def test_moe_prefill_and_train_match_the_reference(world):
    """moonshot's MoE SMOKE at 1x2 with attention over 'model': the
    prefill cell's logits and cache against the reference's one-device
    prefill; one train step (2 microbatches) against ``jax.grad`` of the
    reference's cell on its 1x2 mesh, the state gathered whole."""
    ref = world["ref"]
    for r in world["ranks"][:2]:
        _logits_close(r["moe/prefill/logits"], ref["moe/prefill/logits"],
                      "moe prefill")
        _cache_close(r["moe/prefill/cache/k"], ref["moe/prefill/cache/k"],
                     "moe cache k")
        np.testing.assert_allclose(r["moe/train/loss"], ref["moe/train/loss"],
                                   rtol=1e-5)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(r["moe/train/" + k],
                                       ref["moe/train/" + k], rtol=1e-4,
                                       err_msg=k)
        lr = float(ref["moe/train/lr"])
        for name, want in ref.items():
            if not name.startswith("moe/train/state/"):
                continue
            path, got = name[len("moe/train/state/"):], r[name]
            if path.startswith("params/"):
                np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr,
                                           err_msg=path)
            elif path.startswith(("opt/m/", "opt/v/")):
                np.testing.assert_allclose(
                    got, want, rtol=1e-4,
                    atol=GRAD_ATOL * float(np.abs(want).max()), err_msg=path)
            else:
                np.testing.assert_array_equal(got, want, err_msg=path)
    calls = json.loads(str(world["ranks"][0]["moe/prefill/calls"]))
    # attention's wo and the experts' combine summed over 'model' a layer
    assert calls["sum_over_group"] == 1 + 2 * _port_cfg("moe").n_layers


def test_moe_gather_dispatch_train_matches_one_device(world):
    """The MoE train step at 1x2 with the gather dispatch (the stacks
    stored as the reference's blocks, gathered whole, the FFN the same on
    both model ranks) against the port's one-device step (the reference's
    gather path raises under a mesh on jax 0.9.0)."""
    c = dataclasses.replace(_port_cfg("moe"), moe=dataclasses.replace(
        _port_cfg("moe").moe, impl="gather"))
    tree = {}
    for k, v in world["data"].items():
        if k.startswith("moe/p/"):
            *path, leaf = k[6:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    params = params_from_arrays("lm", tree, "cpu")
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"],
                              batch=TRAIN["batch"], seq_len=TRAIN["seq"])
    cell = api.build_cell(c, "train_4k", device="cpu", shape_override=shp,
                          opt_cfg=OptConfig(**OPT))
    from repro_torch.optim.optimizer import adamw_init
    state, m = cell.step({"params": params, "opt": adamw_init(params)}, {
        "tokens": torch.from_numpy(world["data"]["tokens"]),
        "labels": torch.from_numpy(world["data"]["labels"])})
    lr = float(m["lr"])
    for r in world["ranks"][:2]:
        np.testing.assert_allclose(r["moe_gather/train/loss"],
                                   float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["moe_gather/train/grad_norm"],
                                   float(m["grad_norm"]), rtol=1e-4)
        for path, want in _flatten_with_paths(state):
            want, got = want.numpy(), r["moe_gather/train/state/" + path]
            if path.startswith("params/"):
                np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr,
                                           err_msg=path)
            elif path.startswith(("opt/m/", "opt/v/")):
                np.testing.assert_allclose(
                    got, want, rtol=1e-4,
                    atol=GRAD_ATOL * float(np.abs(want).max()), err_msg=path)
            else:
                np.testing.assert_array_equal(got, want, err_msg=path)


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


@pytest.mark.parametrize("key", ("tinyllama", "smollm", "int8", "moe"))
def test_world_one_equals_no_mesh_bit_for_bit(group, key):
    """At world 1 (mesh 1x1) the train, prefill and decode cells step as
    the cells without a mesh, bit for bit, and make no collective."""
    from repro_torch.parallel import CALLS
    c = _port_cfg(key)
    lm = shapes_for_family("lm")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, c.vocab, (2, SEQ + 1), generator=g,
                         dtype=torch.int32)
    batches = {"train_4k": {"tokens": toks[:, :-1].contiguous(),
                            "labels": toks[:, 1:].contiguous()},
               "prefill_32k": {"tokens": toks[:, :SEQ].contiguous()},
               "decode_32k": {"token": toks[:, :1].contiguous(),
                              "pos": torch.tensor(3, dtype=torch.int32)}}
    CALLS.clear()
    for name, batch in batches.items():
        shp = dataclasses.replace(lm[name], batch=2, seq_len=SEQ)
        outs = []
        for mesh in (group, None):
            cell = api.build_cell(c, name, device="cpu", shape_override=shp,
                                  opt_cfg=OptConfig(**OPT), mesh=mesh)
            state = api.materialize_state(cell, c, name,
                                          torch.Generator().manual_seed(0))
            outs.append(cell.step(state, batch))
        for (p, x), (_, y) in zip(_flatten_with_paths(outs[0]),
                                  _flatten_with_paths(outs[1])):
            assert torch.equal(x, y), (name, p)
    assert not CALLS


def test_moe_trainer_on_a_world_one_mesh(group):
    """``Trainer(mesh=)`` takes an MoE arch: at world 1 it trains as the
    Trainer without a mesh, losses and every leaf bit for bit."""
    from repro_torch.launch.train import Trainer
    runs = []
    for mesh in (group, None):
        tr = Trainer(MOE, smoke=True, device="cpu", mesh=mesh,
                     batch_override=4, seq_override=8)
        tr.run(2, log_every=100)
        runs.append(tr)
    a, b = runs
    assert a.cell.expert_mesh is not None and b.cell.expert_mesh is None
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    for (p, x), (_, y) in zip(_flatten_with_paths(a.state),
                              _flatten_with_paths(b.state)):
        assert torch.equal(x, y), p
