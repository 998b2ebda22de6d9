"""The port's GNN dense-batch forward on the CPU against the JAX package:
kernel 9's plain version against the reference's Pallas ``batched_mp``
(interpret mode) at the reference tests' sweep shapes and at the molecule
shape of every GNN config's width, then ``forward_dense`` for the four
convs (gin, gcn, sage through kernel 9's contract; gatedgcn's einsums)
against the reference's with ``use_pallas=True``. Params come from the
reference's ``init_params`` through ``models.convert.params_from_arrays``;
the inputs are numpy, from a seed.

Tolerances: rtol 1e-5, atol 1e-5 for the kernel (float32 sums of at most
128 terms in another order); rtol 1e-4, atol 1e-5 for the multi-layer
forwards (up to 16 layers, each rounding in its own order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import shapes_for_family
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.kernels.batched_mp import batched_mp as ref_kernel
from repro.models import gnn as ref_gnn
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import _lib, ops
from repro_torch.kernels.batched_mp import (batched_mp, batched_mp_plain,
                                            mma_plan, route, smem_bytes,
                                            tiles)
from repro_torch.models import gnn
from repro_torch.models.convert import params_from_arrays

pytestmark = pytest.mark.arch

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)
GNN_ARCHS = ("gin-tu", "gcn-cora", "graphsage-reddit", "gatedgcn")
H100_SMEM = 232_448


def _mp_inputs(rng, b, n, f, h):
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    x = rng.standard_normal((b, n, f)).astype(np.float32)
    w = (rng.standard_normal((f, h)) * np.sqrt(2 / (f + h))).astype(
        np.float32)
    return adj, x, w


@pytest.mark.parametrize("b,n,f,h", [
    # the reference's kernel sweep
    (1, 8, 8, 8), (4, 16, 8, 12), (2, 32, 64, 16), (8, 30, 16, 2),
    # the molecule shape at each GNN config's widths (gin: w = eye(F))
    (16, 30, 16, 16), (16, 30, 16, 64), (16, 30, 64, 64),
    (16, 30, 16, 128), (16, 30, 128, 128), (16, 30, 16, 70),
    (16, 30, 70, 70),
])
def test_plain_matches_reference_kernel(b, n, f, h):
    adj, x, w = _mp_inputs(np.random.default_rng(b + n + f + h), b, n, f, h)
    want = ref_kernel(jnp.asarray(adj), jnp.asarray(x), jnp.asarray(w),
                      interpret=True)
    got = batched_mp_plain(*(torch.from_numpy(a) for a in (adj, x, w)))
    assert got.shape == (b, n, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    adj, x, w = (torch.from_numpy(a) for a in _mp_inputs(
        np.random.default_rng(0), 4, 30, 16, 16))
    before = dict(_lib.LAUNCHES)
    np.testing.assert_array_equal(batched_mp(adj, x, w).numpy(),
                                  batched_mp_plain(adj, x, w).numpy())
    assert ops.batched_mp is batched_mp
    assert dict(_lib.LAUNCHES) == before


@pytest.mark.parametrize("n,f,h,want", [
    (30, 64, 64, (30, 64, 64)),      # the molecule shape: one tile
    (30, 128, 128, (30, 128, 128)),
    (128, 128, 128, (128, 64, 128)),     # 320 KB whole: F cut in two
    (200, 128, 128, (200, 8, 64)),   # F down to 8, then H
    # adj no longer fits whole: F cut to 8, then row tiles of adj
    (240, 64, 64, (120, 8, 64)),
    (512, 64, 64, (64, 8, 64)),
    (1024, 64, 64, (32, 8, 64)),     # 4 MiB of adj, a quarter of VMEM
    (6448, 64, 64, (1, 8, 8)),       # the largest: 51,584 blocks a graph
])
def test_tiles_fit_the_cards_shared_memory(n, f, h, want):
    rt, ft, ht = tiles(n, f, h, H100_SMEM)
    assert (rt, ft, ht) == want
    assert smem_bytes(n, rt, ft, ht) <= H100_SMEM
    if (rt, ft, ht) != (n, f, h):
        assert smem_bytes(n, n, f, h) > H100_SMEM
    if rt < n:       # no F and H tiles fit beside the whole adj
        assert smem_bytes(n, n, 1, 1) > H100_SMEM


def test_tiles_refuse_a_graph_too_large():
    """At N 30,000 even one row of adj beside one column of x is more
    than a block's shared memory."""
    with pytest.raises(ValueError, match="232448"):
        tiles(30_000, 16, 16, H100_SMEM)


@pytest.mark.parametrize("n", [6449, 8000])
def test_tiles_refuse_more_blocks_than_the_grid_holds(n):
    """From N 6,449 at F = H = 64 the only tiles that fit (RT 1) take
    more blocks a graph than grid.y's 65,535."""
    with pytest.raises(ValueError, match="65535"):
        tiles(n, 64, 64, H100_SMEM)


# the (F, H) of every kernel-9 call on the gnn path: d_feat 16 into gin's
# 64-wide layers (w = eye), gcn's 16, sage's 16 -> 128 -> 128
GNN_CALLS = [(30, 16, 16), (30, 64, 64), (30, 16, 128), (30, 128, 128)]


@pytest.mark.parametrize("n,f,h", GNN_CALLS)
def test_route_takes_the_tensor_cores_on_every_gnn_call(n, f, h):
    assert route(n, f, h, H100_SMEM) == "mma"
    assert route(n, f, h) == "mma"            # the H100's limit by default


@pytest.mark.parametrize("n,f,h,want", [
    (64, 64, 64, "mma"), (64, 128, 128, "mma"), (1, 1, 1, "mma"),
    (17, 9, 3, "mma"), (30, 70, 70, "mma"),
    (65, 64, 64, "tiled"), (30, 129, 64, "tiled"), (30, 64, 129, "tiled"),
    (240, 64, 64, "tiled"), (1024, 64, 64, "tiled"), (6448, 64, 64, "tiled"),
])
def test_route_by_shape(n, f, h, want):
    assert route(n, f, h) == want


@pytest.mark.parametrize("n,f,h", [(6449, 64, 64), (30_000, 16, 16),
                                   (0, 16, 16), (30, 0, 16)])
def test_route_refuses_what_no_route_takes(n, f, h):
    with pytest.raises(ValueError):
        route(n, f, h)


@pytest.mark.parametrize("n", [1, 8, 16, 17, 30, 32, 33, 40, 48, 64])
@pytest.mark.parametrize("f,h", [(1, 1), (16, 16), (64, 64), (16, 128),
                                 (70, 70), (128, 128), (128, 16)])
def test_mma_plan_fits_the_cards_shared_memory(n, f, h):
    """Every shape within the tensor-core route's bounds, its largest
    (N 64, F = H = 128) included, gets at least one pipeline in 227 KB."""
    plan = mma_plan(n, f, h, H100_SMEM)
    assert plan["pairs"] >= 1 and plan["smem"] <= H100_SMEM
    assert plan["pairs"] <= (4 if plan["kf"] == 16 else 8)
    assert plan["kf"] * 8 >= f and plan["stages"] in (1, 2)
    if plan["stages"] == 1:
        assert plan["w_bytes"] + 2 * plan["pairs"] * plan["stage_bytes"] \
            > H100_SMEM


@pytest.mark.parametrize("n", [8, 16, 24, 30, 32, 40, 48, 64])
@pytest.mark.parametrize("f", [16, 30, 64, 70, 128])
def test_mma_layout_keeps_banks_apart(n, f):
    """The kernel's fragment loads on the plan's row strides: the 32
    lanes of a load hit 32 different banks (adj's A fragment: row g,
    column 8·ks + t; x's B fragment: row 8·ks + t, column 8·j + g), and
    each quarter-warp's 16-byte loads of the split w 8 different
    four-bank groups (float4 row 4·ks + t, column 8·j + g)."""
    plan = mma_plan(n, f, 64)
    kn, sa, sx = -(-n // 8) * 8, plan["sa"], plan["sx"]
    sw4 = -(-64 // (8 * plan["hc"])) * 8 * plan["hc"] + 2
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for ks in range(kn // 8):
        for extra in (0, 4):
            assert len(set((g * sa + 8 * ks + t + extra) % 32)) == 32
        for j in range(plan["kf"]):
            assert len(set(((8 * ks + t) * sx + 8 * j + g) % 32)) == 32
    for ks in range(plan["kf"]):
        for quarter in range(4):
            lanes = slice(8 * quarter, 8 * quarter + 8)
            groups = ((4 * ks + t[lanes]) * sw4 + 8 + g[lanes]) % 8
            assert len(set(groups)) == 8


def _dense_batch(rng, shp, b):
    n = shp.nodes_per_graph
    adj = (rng.random((b, n, n)) < 0.2).astype(np.float32)
    feats = rng.standard_normal((b, n, shp.d_feat)).astype(np.float32)
    return adj, feats


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_forward_dense_matches_reference(arch, smoke):
    cfg = (ref_get_smoke if smoke else ref_get_config)(arch)
    tcfg = (get_smoke if smoke else get_config)(arch)
    shp = shapes_for_family("gnn")["molecule"]
    p = ref_gnn.init_params(cfg, jax.random.PRNGKey(3), shp.d_feat,
                            shp.n_classes)
    tp = params_from_arrays("gnn", jax.tree.map(np.asarray, p), "cpu")
    rng = np.random.default_rng(4)
    adj, feats = _dense_batch(rng, shp, 8 if smoke else 4)
    # a graph with no edges and a node with none
    adj[0] = 0.0
    adj[1, 3, :] = 0.0
    adj[1, :, 3] = 0.0
    want = ref_gnn.forward_dense(cfg, p, jnp.asarray(adj),
                                 jnp.asarray(feats), use_pallas=True)
    got = gnn.forward_dense(tcfg, tp, torch.from_numpy(adj),
                            torch.from_numpy(feats))
    assert got.shape == (adj.shape[0], shp.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_init_params_tree_matches_reference(arch):
    cfg = ref_get_config(arch)
    shp = shapes_for_family("gnn")["molecule"]
    want = ref_gnn.init_params(cfg, jax.random.PRNGKey(0), shp.d_feat,
                               shp.n_classes)
    got = gnn.init_params(get_config(arch), torch.Generator().manual_seed(0),
                          shp.d_feat, shp.n_classes, "cpu")
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.asarray(t), got))[0]
    assert [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
            for k, v in flat_got] == [
        (jax.tree_util.keystr(k), v.shape, str(v.dtype))
        for k, v in flat_want]
    # glorot scale: std sqrt(2 / (fan_in + fan_out)) on the widest weight
    w = got["layers"][-1]["w_self"]
    assert abs(float(w.std()) / (2 / sum(w.shape)) ** 0.5 - 1) < 0.1


def test_convert_refuses_unknown_leaves():
    cfg = ref_get_smoke("gin-tu")
    p = jax.tree.map(np.asarray, ref_gnn.init_params(
        cfg, jax.random.PRNGKey(0), 16, 2))
    p["layers"][0] = {**p["layers"][0], "extra": np.zeros(2, np.float32)}
    with pytest.raises(KeyError):
        params_from_arrays("gnn", p, "cpu")
    with pytest.raises(KeyError):
        params_from_arrays("recsys", {"table": np.zeros((2, 2))}, "cpu")
