"""Expert parallelism in the port (``transformer._moe_ffn_expert_parallel``
over ``core.distributed.ServingMesh``, ``parallel.collectives``) on the
CPU, against the reference's ``_moe_ffn_shardmap``.

The port's ranks are subprocesses of one gloo process group (a FileStore
under the test's temporary directory, no network): world 4 as mesh 2x2
and world 2 as mesh 1x2. The reference runs in a subprocess of its own
that sets ``--xla_force_host_platform_device_count`` before JAX loads, so
that this process keeps seeing one device. At moonshot-v1-16b-a3b's
SMOKE widths (8 experts, top 2) with ``impl="shard_map"``, in both modes
(tokens sharded over the data ranks, and tokens replicated with the
experts' mlp dim over the data ranks) and at capacity factors 8 (nothing
drops) and 0.5 (drop-heavy), the port's output and the gradients of
sum(out²) with respect to the layer's params and x, assembled from the
ranks, must equal the reference's; where nothing drops, also the gather
path's without a mesh (the reference's gather path raises under a mesh on
jax 0.9.0). The drop-heavy case zeroes exactly the tokens whose every
assignment overflowed its data shard's capacity (GShard).

At 2x2 the MoE train step (2 microbatches, remat; attention over
'model', the state the reference's blocks) equals the port's one-device
step on the whole batch where nothing drops, and the prefill and decode
cells on the mesh equal the one-device cells. At 1x2 the two
collectives' gradients are checked directly: ``sum_over_group``'s
backward passes the cotangent through (summing it again would double
every gradient behind it). World 1 runs in this process.

Tolerances: outputs at rtol 2e-5, atol 2e-5 (the reference's shard_map
test); gradients at atol 5e-4 × the largest magnitude (its 5e-4); a
train step at the one-device train tests' (loss rtol 1e-5, params atol
2·lr, m and v rtol 1e-4 and atol 5e-4 × max|want|).
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
import torch.distributed as dist

from repro.configs.registry import get_smoke as ref_get_smoke
from repro.models import transformer as ref_tf
from repro.parallel.sharding import NO_SHARDING
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.core.distributed import ServingMesh
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_arrays
from repro_torch.optim.optimizer import OptConfig, adamw_init

pytestmark = pytest.mark.arch

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "moonshot-v1-16b-a3b"
CFS = (8.0, 0.5)
MESHES = ((2, 2), (1, 2))
MODES = ("sharded", "replicated")
TIMEOUT = 240                # seconds, each subprocess
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_ATOL = 5e-4
OPT = dict(warmup_steps=10, total_steps=100)
TRAIN = dict(batch=8, seq=8, microbatches=2)
SERVE = dict(batch=4, seq=8)

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from dataclasses import replace
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.registry import get_smoke
from repro.models import transformer as tf
from repro.parallel.sharding import ShardingCtx
cfg = json.loads(sys.argv[1])
data = dict(np.load(cfg["data"]))
base = get_smoke(cfg["arch"])
lp = {k: jnp.asarray(data[k]) for k in ("router", "w_gate", "w_up", "w_down")}
out = {}
for d, m in cfg["meshes"]:
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    for mode in cfg["modes"]:
        ctx = ShardingCtx(mesh, {"mlp": "data"} if mode == "replicated"
                          else None)
        x = jnp.asarray(data["x"] if mode == "sharded" else data["x"][:, :1])
        for cf in cfg["cfs"]:
            c = replace(base, moe=replace(base.moe, capacity_factor=cf,
                                          dispatch="sort", impl="shard_map"))
            f = lambda lp, x: tf._moe_ffn_shardmap(c, lp, x, ctx)
            key = f"{d}x{m}_{mode}_{cf}"
            out[key + "/out"] = np.asarray(jax.jit(f)(lp, x))
            g_lp, g_x = jax.jit(jax.grad(lambda lp, x: jnp.sum(f(lp, x) ** 2),
                                         argnums=(0, 1)))(lp, x)
            out[key + "/dx"] = np.asarray(g_x)
            for k, v in g_lp.items():
                out[key + "/d" + k] = np.asarray(v)
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
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.core.distributed import ServingMesh
from repro_torch.models import api, transformer as tf
from repro_torch.models.convert import params_from_arrays
from repro_torch.optim.optimizer import OptConfig, adamw_init
from repro_torch.parallel import CALLS, all_reduce_, copy_to_group, sum_over_group
from repro_torch.parallel import sharding as shd
from repro_torch.checkpoint.checkpoint import gather_state
data = dict(np.load(cfg["data"]))
mesh = ServingMesh("sharded", tuple(cfg["mesh"]), "cpu")
base = get_smoke(cfg["arch"])
out = {}

def moe_cfg(cf):
    return replace(base, moe=replace(base.moe, capacity_factor=cf,
                                     dispatch="sort", impl="shard_map"))

def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))

for mode in cfg["modes"]:
    for cf in cfg["cfs"]:
        c = moe_cfg(cf)
        ep = tf.ExpertMesh(mesh, tokens_sharded=mode == "sharded",
                           mlp_over_data=mode == "replicated")
        e, f = tf.expert_slices(c, ep)
        x = data["x"] if mode == "sharded" else data["x"][:, :1]
        if mode == "sharded":
            b = x.shape[0] // mesh.n_data
            x = x[mesh.d * b:(mesh.d + 1) * b]
        lp = {"router": t(data["router"]), "w_gate": t(data["w_gate"][e, :, f]),
              "w_up": t(data["w_up"][e, :, f]), "w_down": t(data["w_down"][e, f])}
        lp = {k: v.requires_grad_() for k, v in lp.items()}
        xg = t(x).requires_grad_()
        y = tf._moe_ffn(c, lp, xg, ep)
        (y ** 2).sum().backward()
        key = f"{mode}_{cf}"
        out[key + "/out"] = y.detach().numpy()
        out[key + "/dx"] = xg.grad.numpy()
        for k, v in lp.items():
            if mode == "sharded":     # each data rank's tokens' share
                all_reduce_(v.grad, mesh.data_group)
            out[key + "/d" + k] = v.grad.numpy()
        out[key + "/slices"] = np.array([e.start, e.stop, f.start or 0,
                                         f.stop or base.d_ff])

if cfg.get("unit"):
    a = torch.ones(3, requires_grad=True)
    s = sum_over_group(a * (mesh.m + 1), mesh.model_group)
    s.sum().backward()
    u = torch.ones(3, requires_grad=True)
    (copy_to_group(u, mesh.model_group) * (mesh.m + 1)).sum().backward()
    out.update({"unit/sum": s.detach().numpy(), "unit/sum_grad": a.grad.numpy(),
                "unit/copy_grad": u.grad.numpy()})
    # 3 experts over 2 model ranks: the gather path on the rank's tokens
    odd = replace(moe_cfg(8.0), moe=replace(moe_cfg(8.0).moe, n_experts=3))
    lp = {"router": t(data["router"][:, :3]), "w_gate": t(data["w_gate"][:3]),
          "w_up": t(data["w_up"][:3]), "w_down": t(data["w_down"][:3])}
    CALLS.clear()
    out["unit/odd"] = tf._moe_ffn(odd, lp, t(data["x"]),
                                  tf.ExpertMesh(mesh)).numpy()
    out["unit/odd_calls"] = np.array(sum(CALLS.values()))

if cfg.get("cells"):
    params = {}
    for k, v in data.items():
        if k.startswith("p/"):
            *path, leaf = k[2:].split("/")
            node = params
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    c = replace(moe_cfg(8.0), microbatches=cfg["train"]["microbatches"],
                remat=True)
    lm = shapes_for_family("lm")
    shp = replace(lm["train_4k"], batch=cfg["train"]["batch"],
                  seq_len=cfg["train"]["seq"])
    cell = api.build_cell(c, "train_4k", mesh=mesh, shape_override=shp,
                          opt_cfg=OptConfig(**cfg["opt"]))
    drawn = api.materialize_state(cell, c, "train_4k",
                                  torch.Generator().manual_seed(0))
    out["train/drawn_w_gate_shape"] = np.array(
        drawn["params"]["layers"]["w_gate"].shape)
    whole = params_from_arrays("lm", params, "cpu")
    state = api.shard_state(cell, {"params": whole,
                                   "opt": adamw_init(whole)})
    CALLS.clear()
    state, metrics = cell.step(state, {"tokens": t(data["tokens"]),
                                       "labels": t(data["labels"])})
    out["train/calls"] = np.array([CALLS["sum_over_group"],
                                   CALLS["copy_to_group"], CALLS["grad_sum"]])
    for k in ("loss", "grad_norm", "lr"):
        out["train/" + k] = np.array(float(metrics[k]))
    for path, v in _flatten_with_paths(gather_state(
            state, cell.state_shardings())):
        out["train/state/" + path] = v.numpy()
    full = params_from_arrays("lm", params, "cpu")
    sc = moe_cfg(8.0)
    s_shp = replace(lm["prefill_32k"], batch=cfg["serve"]["batch"],
                    seq_len=cfg["serve"]["seq"])
    cell = api.build_cell(sc, "prefill_32k", mesh=mesh, shape_override=s_shp)
    _, res = cell.step(api.shard_state(cell, {"params": full}),
                       {"tokens": t(data["prompt"])})
    out["prefill/logits"] = res["logits"].numpy()
    k_shape = tuple(tf.cache_shapes(sc, *data["prompt"].shape)["k"])
    spec = shd.logical_to_spec(tf.cache_logical_axes(sc)["k"], k_shape, mesh)
    out["prefill/cache_k"] = shd.gather(res["cache"]["k"], spec,
                                        mesh).numpy()
    d_shp = replace(lm["decode_32k"], batch=cfg["serve"]["batch"],
                    seq_len=cfg["serve"]["seq"])
    cell = api.build_cell(sc, "decode_32k", mesh=mesh, shape_override=d_shp)
    n = cfg["serve"]["seq"] - 1
    _, cache = tf.prefill(sc, full, t(data["prompt"][:, :n]), n + 1)
    state = api.shard_state(cell, {"params": full,
                                   "cache": tf.quantize_cache(cache)})
    _, logits = cell.step(state, {"token": t(data["prompt"][:, n:]),
                                  "pos": torch.tensor(n, dtype=torch.int32)})
    out["decode/logits"] = logits.numpy()
np.savez(cfg["out"] % rank, **out)
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


def _cfg(cf=8.0):
    cfg = ref_get_smoke(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, dispatch="sort", impl="shard_map"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the reference's outputs and gradients, and every port
    rank's outputs (a list a mesh)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg = _cfg()
    p = jax.tree.map(np.asarray, ref_tf.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    data = {k: v[0] for k, v in p["layers"].items()
            if k in ("router", "w_gate", "w_up", "w_down")}
    data["x"] = rng.standard_normal((8, 4, cfg.d_model)).astype(np.float32)
    for path, v in _flatten_with_paths(p):
        data["p/" + path] = v
    toks = rng.integers(0, cfg.vocab, (TRAIN["batch"], TRAIN["seq"] + 1))
    data["tokens"] = toks[:, :-1].astype(np.int32)
    data["labels"] = toks[:, 1:].astype(np.int32)
    data["prompt"] = rng.integers(0, cfg.vocab, (SERVE["batch"],
                                                 SERVE["seq"])).astype(
        np.int32)
    np.savez(tmp / "data.npz", **data)
    common = dict(data=str(tmp / "data.npz"), arch=ARCH, cfs=list(CFS),
                  modes=list(MODES))
    procs = [("ref", REF, dict(common, meshes=[list(m) for m in MESHES],
                               out=str(tmp / "ref.npz")), 1)]
    for d, m in MESHES:
        name = f"{d}x{m}"
        procs.append((name, RANK, dict(
            common, world=d * m, mesh=[d, m], store=str(tmp / f"{name}.s"),
            out=str(tmp / f"{name}_rank%d.npz"), unit=(d, m) == (1, 2),
            cells=(d, m) == (2, 2), train=TRAIN, serve=SERVE, opt=OPT),
            d * m))
    for _, script, argv, n in procs:      # one at a time: gloo ranks wait
        _run(script, argv, n)
    ref = dict(np.load(tmp / "ref.npz"))
    ranks = {f"{d}x{m}": [dict(np.load(tmp / f"{d}x{m}_rank{r}.npz"))
                          for r in range(d * m)] for d, m in MESHES}
    return data, ref, ranks


def _assemble(ranks, mesh, mode, cf):
    """The whole output, x gradient and params' gradients of one case from
    its ranks: the output and x's gradient by data rank (tokens sharded)
    or any rank's (replicated), each the same over the ranks that share
    it; each rank's expert slices placed, ranks holding the same slice
    agreeing bit for bit."""
    d_n, m_n = mesh
    case = f"{mode}_{cf}"
    for i, r in enumerate(ranks):
        head = ranks[(i // m_n) * m_n] if mode == "sharded" else ranks[0]
        for k in ("out", "dx", "drouter"):
            np.testing.assert_array_equal(r[f"{case}/{k}"],
                                          head[f"{case}/{k}"], err_msg=k)
    heads = ([ranks[d * m_n] for d in range(d_n)] if mode == "sharded"
             else ranks[:1])
    got = {k: np.concatenate([r[f"{case}/{k}"] for r in heads])
           for k in ("out", "dx")}
    got["drouter"] = ranks[0][f"{case}/drouter"]
    pcfg = get_smoke(ARCH)
    E, D, F = pcfg.moe.n_experts, pcfg.d_model, pcfg.d_ff
    for k in ("dw_gate", "dw_up", "dw_down"):
        f_dim = 1 if k == "dw_down" else 2
        shape = [E, D, D]
        shape[f_dim] = F
        full = np.full(shape, np.nan, np.float32)
        for r in ranks:
            e0, e1, f0, f1 = r[f"{case}/slices"]
            idx = [slice(e0, e1), slice(None), slice(None)]
            idx[f_dim] = slice(f0, f1)
            part = full[tuple(idx)]
            if not np.isnan(part).all():
                np.testing.assert_array_equal(part, r[f"{case}/{k}"])
            full[tuple(idx)] = r[f"{case}/{k}"]
        assert not np.isnan(full).any(), k
        got[k] = full
    return got


def _grad_close(got, want, what):
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL * top,
                               err_msg=what)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x2"])
def test_expert_parallel_ffn_matches_reference_shardmap(world, mesh, mode,
                                                        cf):
    _, ref, ranks = world
    name = f"{mesh[0]}x{mesh[1]}"
    got = _assemble(ranks[name], mesh, mode, cf)
    want = {k.split("/")[1]: v for k, v in ref.items()
            if k.startswith(f"{name}_{mode}_{cf}/")}
    np.testing.assert_allclose(got["out"], want["out"], **OUT_TOL)
    for k in ("dx", "drouter", "dw_gate", "dw_up", "dw_down"):
        _grad_close(got[k], want[k], k)


@pytest.mark.parametrize("mode", MODES)
def test_expert_parallel_equals_gather_path_where_nothing_drops(world, mode):
    data, _, ranks = world
    cfg = _cfg(8.0)
    lp = {k: data[k] for k in ("router", "w_gate", "w_up", "w_down")}
    x = data["x"] if mode == "sharded" else data["x"][:, :1]
    want = np.asarray(ref_tf._moe_ffn_gather(cfg, lp, x, NO_SHARDING))
    for mesh in MESHES:
        got = _assemble(ranks[f"{mesh[0]}x{mesh[1]}"], mesh, mode, 8.0)
        np.testing.assert_allclose(got["out"], want, **OUT_TOL)


def test_tight_capacity_drops_per_data_shard(world):
    """Capacity 0.5 at 2x2, tokens sharded: the output is finite, and a
    token's row is zero exactly where every one of its K assignments
    overflowed its data shard's capacity (the shard's own queues)."""
    data, _, ranks = world
    got = _assemble(ranks["2x2"], (2, 2), "sharded", 0.5)["out"]
    assert np.isfinite(got).all()
    pcfg = dataclasses.replace(get_smoke(ARCH), moe=dataclasses.replace(
        get_smoke(ARCH).moe, capacity_factor=0.5))
    moe, D = pcfg.moe, pcfg.d_model
    router = torch.from_numpy(data["router"].copy())
    dropped_all = []
    for shard in np.split(data["x"], 2):
        xf = torch.from_numpy(shard.reshape(-1, D))
        C = tf.capacity(moe, xf.shape[0])
        gates, experts = tf.route(moe, router, xf)
        _, _, slot = tf.dispatch_tables(gates, experts, moe.n_experts, C)
        dropped_all.append((slot == moe.n_experts * C).all(-1).numpy())
    dropped_all = np.concatenate(dropped_all)
    zero = (got.reshape(-1, D) == 0).all(-1)
    assert dropped_all.any() and not dropped_all.all()
    np.testing.assert_array_equal(zero, dropped_all)


def test_collective_gradients_at_m2(world):
    """At 1x2: ``sum_over_group`` sums the forward (1 + 2) and passes the
    cotangent through (rank m's input scaled by m + 1 gets m + 1, not
    M·(m + 1)); ``copy_to_group`` sums the cotangent (1 + 2). With 3
    experts over the 2 model ranks each rank runs the gather path on its
    own tokens (the reference's fallback rule) and launches nothing."""
    data, _, ranks = world
    cfg = dataclasses.replace(get_smoke(ARCH), moe=dataclasses.replace(
        get_smoke(ARCH).moe, n_experts=3, capacity_factor=8.0,
        dispatch="sort", impl="shard_map"))
    lp = {"router": data["router"][:, :3], "w_gate": data["w_gate"][:3],
          "w_up": data["w_up"][:3], "w_down": data["w_down"][:3]}
    want = tf._moe_ffn(cfg, {k: torch.from_numpy(v.copy())
                             for k, v in lp.items()},
                       torch.from_numpy(data["x"].copy())).numpy()
    for m, r in enumerate(ranks["1x2"]):
        np.testing.assert_array_equal(r["unit/sum"], np.full(3, 3.0))
        np.testing.assert_array_equal(r["unit/sum_grad"],
                                      np.full(3, m + 1.0))
        np.testing.assert_array_equal(r["unit/copy_grad"], np.full(3, 3.0))
        np.testing.assert_array_equal(r["unit/odd"], want)
        assert int(r["unit/odd_calls"]) == 0


def _one_device(data, kind, shape, cfg_kw):
    pcfg = dataclasses.replace(get_smoke(ARCH), **cfg_kw)
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, capacity_factor=8.0, dispatch="sort", impl="shard_map"))
    tree = {}
    for k, v in data.items():
        if k.startswith("p/"):
            *path, leaf = k[2:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    params = params_from_arrays("lm", tree, "cpu")
    shp = dataclasses.replace(shapes_for_family("lm")[kind], **shape)
    cell = api.build_cell(pcfg, kind, device="cpu", shape_override=shp,
                          opt_cfg=OptConfig(**OPT))
    return pcfg, cell, params


def test_mesh_train_step_equals_one_device_step(world):
    """The 2x2 train step (each data rank a block of every microbatch,
    experts split over the model ranks) against the one-device step on
    the whole batch: loss, grad_norm, lr, and the state after it, each
    rank's experts placed; every rank holds the same copy of every other
    leaf, and a model group the same experts over its data ranks."""
    data, _, ranks = world
    ranks = ranks["2x2"]
    pcfg, cell, params = _one_device(
        data, "train_4k", dict(batch=TRAIN["batch"], seq_len=TRAIN["seq"]),
        dict(microbatches=TRAIN["microbatches"], remat=True))
    state = {"params": params, "opt": adamw_init(params)}
    state, metrics = cell.step(state, {
        "tokens": torch.from_numpy(data["tokens"]),
        "labels": torch.from_numpy(data["labels"])})
    for r in ranks:
        np.testing.assert_allclose(r["train/loss"], float(metrics["loss"]),
                                   rtol=1e-5)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(r[f"train/{k}"], float(metrics[k]),
                                       rtol=1e-4, err_msg=k)
        e_loc = pcfg.moe.n_experts // 2
        assert tuple(r["train/drawn_w_gate_shape"]) == (
            pcfg.n_layers, e_loc, pcfg.d_model, pcfg.d_ff)
    # a microbatch: the vocab-parallel embedding's sum, and a layer's
    # combine and attention's wo over 'model' in the forward, attention's
    # again in the remat recompute (which stops before the combine, the
    # last tensor the backward needs); in the backward a layer's
    # activations into the FFN and attention's normed input, and the
    # loss's hidden states (the router is gathered, its gradient summed
    # by the gather); every leaf's gradient summed over the data ranks
    s, c, g = ranks[0]["train/calls"]
    mb, L = TRAIN["microbatches"], pcfg.n_layers
    assert (s, c) == (mb * (1 + 3 * L), mb * (2 * L + 1)), (s, c)
    assert g == len(_flatten_with_paths(params))
    lr = float(metrics["lr"])
    for path, want in _flatten_with_paths(state):
        want = want.numpy()
        key = "train/state/" + path
        for r in ranks[1:]:          # the state gathered whole on each rank
            np.testing.assert_array_equal(r[key], ranks[0][key],
                                          err_msg=path)
        got = ranks[0][key]
        if path.startswith("params/"):
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr,
                                       err_msg=path)
        elif path.startswith("opt/m/") or path.startswith("opt/v/"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=GRAD_ATOL
                                       * float(np.abs(want).max()),
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


def test_mesh_prefill_and_decode_cells_equal_one_device(world):
    """On the 2x2 mesh: the prefill cell (each data rank two of the four
    prompts, the answers gathered back) and the int8 decode cell (every
    prompt on every rank, the experts' mlp dim split over the data
    ranks) against the one-device cells, where nothing drops."""
    data, _, ranks = world
    shape = dict(batch=SERVE["batch"], seq_len=SERVE["seq"])
    pcfg, cell, params = _one_device(data, "prefill_32k", shape, {})
    _, want = cell.step({"params": params},
                        {"tokens": torch.from_numpy(data["prompt"])})
    n = SERVE["seq"] - 1
    _, cache = tf.prefill(pcfg, params, torch.from_numpy(data["prompt"][:, :n]),
                          n + 1)
    _, dcell, _ = _one_device(data, "decode_32k", shape, {})
    _, want_dec = dcell.step(
        {"params": params, "cache": tf.quantize_cache(cache)},
        {"token": torch.from_numpy(data["prompt"][:, n:]),
         "pos": torch.tensor(n, dtype=torch.int32)})
    for r in ranks["2x2"]:
        top = float(want["logits"].abs().max())
        np.testing.assert_allclose(r["prefill/logits"],
                                   want["logits"].numpy(), rtol=1e-4,
                                   atol=1e-5 * top)
        np.testing.assert_allclose(r["prefill/cache_k"],
                                   want["cache"]["k"].numpy(), rtol=1e-4,
                                   atol=1e-5)
        top = float(want_dec.abs().max())
        np.testing.assert_allclose(r["decode/logits"], want_dec.numpy(),
                                   rtol=1e-4, atol=1e-5 * top)


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group in this process, torn down after."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        yield ServingMesh("sharded", (1, 1), "cpu")
    finally:
        dist.destroy_process_group()


def test_world_one_is_the_one_device_path(group):
    """At 1x1 the expert-parallel FFN holds every expert and launches no
    collective: its output and gradients are the gather path's, drops
    included; the mesh's train cell keeps the whole expert stacks. With
    ``impl="gather"`` a mesh runs the gather path and keeps the stacks
    whole too."""
    from repro_torch.parallel import CALLS
    pcfg = dataclasses.replace(get_smoke(ARCH), moe=dataclasses.replace(
        get_smoke(ARCH).moe, capacity_factor=0.5, impl="shard_map"))
    lp = {k: v[0] for k, v in tf.init_params(
        pcfg, torch.Generator().manual_seed(1), "cpu")["layers"].items()
        if k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.randn(4, 6, pcfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    ep = tf.ExpertMesh(group)
    outs = []
    for mesh in (ep, None):
        leaves = {k: v.clone().requires_grad_() for k, v in lp.items()}
        xg = x.clone().requires_grad_()
        y = tf._moe_ffn(pcfg, leaves, xg, mesh)
        (y ** 2).sum().backward()
        outs.append((y, xg.grad, {k: v.grad for k, v in leaves.items()}))
    (y, dx, g), (y0, dx0, g0) = outs
    assert torch.equal(y, y0) and torch.equal(dx, dx0)
    for k in g:
        assert torch.equal(g[k], g0[k]), k
    assert sum(CALLS.values()) == 0
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"], batch=4,
                              seq_len=8)
    cell = api.build_cell(pcfg, "train_4k", mesh=group, shape_override=shp)
    assert cell.expert_mesh.mesh is group and cell.device.type == "cpu"
    state = api.materialize_state(cell, pcfg, "train_4k",
                                  torch.Generator().manual_seed(0))
    assert state["params"]["layers"]["w_gate"].shape[1] == 8
    gather = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, impl="gather"))
    assert tf.expert_slices(gather, ep) is None
    cell = api.build_cell(gather, "train_4k", mesh=group, shape_override=shp)
    state = api.materialize_state(cell, gather, "train_4k",
                                  torch.Generator().manual_seed(0))
    assert state["params"]["layers"]["w_gate"].shape[1] == 8
