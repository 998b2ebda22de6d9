"""GNN training on the CPU against the JAX package: the substrate ops
(``segment_mp``, ``embedding_bag``) against the reference's, the
full-graph and sampled-subgraph forwards for the four convs, kernel 9's
autograd Function (``BatchedMP``: its backward is kernel 9 again, here
its plain version) against autograd of the plain einsums, remat against
none, and two steps of every GNN train cell against the reference's
jitted step. Params and optimizer states come from the reference's
``materialize_state`` through ``models.convert.state_from_arrays``; the
batches are numpy, from a seed.

Tolerances: rtol 1e-4, atol 1e-5 for forwards, losses, params and
optimizer moments (several layers, each rounding in its own order);
rtol 1e-5, atol 1e-5 × the largest magnitude for ``BatchedMP``'s
gradients against autograd of the same plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import shapes_for_family as ref_shapes
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.kernels import ops as ref_ops
from repro.models import api as ref_api
from repro.models import gnn as ref_gnn
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.kernels import ops
from repro_torch.kernels.batched_mp import BatchedMP, batched_mp_plain
from repro_torch.models import api, gnn
from repro_torch.models.convert import params_from_arrays, state_from_arrays

pytestmark = pytest.mark.arch

TOL = dict(rtol=1e-4, atol=1e-5)
GNN_ARCHS = ("gin-tu", "gcn-cora", "graphsage-reddit", "gatedgcn")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# minibatch_lg cut for the CPU: 16 targets, fanout (3, 2); the published
# d_feat 602 and 41 classes stay
MINIBATCH_CUT = dict(batch_nodes=16, fanout=(3, 2))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


def _flat(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists, the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


# ------------------------------------------------------------ the ops ----
def _segments(rng, m, n, f):
    """x [m, f] and ids [m] in [0, n) that leave some segments empty."""
    x = rng.standard_normal((m, f)).astype(np.float32)
    ids = rng.integers(0, n // 2, m).astype(np.int32) * 2   # odd ids empty
    return x, ids


@pytest.mark.parametrize("reduce", ["sum", "max", "mean"])
@pytest.mark.parametrize("m,n,f", [(1, 4, 3), (97, 40, 8), (1000, 64, 16)])
def test_segment_mp_matches_reference(reduce, m, n, f):
    x, ids = _segments(np.random.default_rng(m + n), m, n, f)
    want = ref_ops.segment_mp(jnp.asarray(x), jnp.asarray(ids), n, reduce)
    got = ops.segment_mp(torch.from_numpy(x), torch.from_numpy(ids), n,
                         reduce)
    assert got.shape == want.shape and got.dtype == torch.float32
    if reduce == "max":     # empty segments at the scatter's identity
        assert torch.isneginf(got[1::2]).all()
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(np.asarray(want)))
    _close(got, want, reduce)


def test_segment_sum_backward_keeps_only_the_ids():
    """The messages [m, F] are not kept for the backward (index_add's own
    backward would keep them): only the gather's and the scatter's ids."""
    x = torch.randn(50, 8, requires_grad=True)
    src = torch.randint(0, 50, (400,), dtype=torch.int32)
    dst = torch.randint(0, 30, (400,), dtype=torch.int32)
    saved = []

    def pack(t):
        saved.append(t.dtype)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ops.segment_mp(torch.index_select(x, 0, src), dst, 30)
    assert saved and all(not d.is_floating_point for d in saved)
    (g,) = torch.autograd.grad(out.square().sum(), x)
    ref = torch.zeros(30, 8).index_add(0, dst.long(),
                                       torch.index_select(x, 0, src))
    (want,) = torch.autograd.grad(ref.square().sum(), x)
    torch.testing.assert_close(g, want)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(mode, weighted):
    rng = np.random.default_rng(7)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 200).astype(np.int32)
    bags = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    w = rng.random(200).astype(np.float32) if weighted else None
    want = ref_ops.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 32,
        None if w is None else jnp.asarray(w), mode)
    got = ops.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(bags), 32,
        None if w is None else torch.from_numpy(w), mode)
    _close(got, want, mode)


# ------------------------------------------------------- kernel 9's grad --
@pytest.mark.parametrize("b,n,f,h", [(1, 8, 8, 8), (4, 30, 16, 64),
                                     (3, 30, 70, 70), (2, 17, 64, 128)])
def test_batched_mp_backward_matches_autograd_of_plain(b, n, f, h):
    rng = np.random.default_rng(b * n + f + h)
    adj = torch.from_numpy((rng.random((b, n, n)) < 0.3).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal((b, n, f)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((f, h)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, n, h)).astype(np.float32))
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = BatchedMP.apply(adj, x, w)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    yr = batched_mp_plain(adj, xr, wr)
    dxr, dwr = torch.autograd.grad(yr, (xr, wr), dy)
    assert torch.equal(y, yr)           # the forward is the plain version
    for got, want in ((dx, dxr), (dw, dwr)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_batched_mp_gives_adj_no_gradient():
    adj = torch.ones((1, 4, 4), requires_grad=True)
    with pytest.raises(ValueError, match="adj takes no gradient"):
        ops.batched_mp(adj, torch.ones((1, 4, 2)), torch.ones((2, 3)))
    # only the gradients asked for are computed
    x = torch.ones((1, 4, 2), requires_grad=True)
    y = ops.batched_mp(torch.ones((1, 4, 4)), x, torch.ones((2, 3)))
    (dx,) = torch.autograd.grad(y.sum(), (x,))
    assert torch.equal(dx, torch.full((1, 4, 2), 12.0))


# ---------------------------------------------------------- the forwards --
def _graph(rng, n, m, d):
    feats = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n - 3, m).astype(np.int32)    # last rows: no edge
    return feats, src, dst


def _params(arch, d_feat, n_classes, seed=0, cfg=None):
    cfg = cfg or ref_get_smoke(arch)
    p = ref_gnn.init_params(cfg, jax.random.PRNGKey(seed), d_feat, n_classes)
    return cfg, p, params_from_arrays("gnn", _np(p), "cpu")


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_forward_full_matches_reference(arch, remat):
    cfg, p, tp = _params(arch, 12, 5)
    cfg = dataclasses.replace(cfg, remat=remat)
    feats, src, dst = _graph(np.random.default_rng(1), 60, 300, 12)
    want = ref_gnn.forward_full(cfg, p, jnp.asarray(feats), jnp.asarray(src),
                                jnp.asarray(dst), 60)
    got = gnn.forward_full(cfg, tp, torch.from_numpy(feats),
                           torch.from_numpy(src), torch.from_numpy(dst), 60)
    _close(got, want, arch)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_minibatch_matches_reference(arch):
    cfg, p, tp = _params(arch, 10, 4, seed=1)
    rng = np.random.default_rng(2)
    sizes = [6, 14, 30, 50][: cfg.n_layers + 1]
    hop_feats = [rng.standard_normal((s, 10)).astype(np.float32)
                 for s in sizes]
    hop_edges = []
    for h in range(len(sizes) - 1):
        e = 3 * sizes[h + 1]
        hop_edges.append((rng.integers(0, sizes[h + 1], e).astype(np.int32),
                          rng.integers(0, sizes[h], e).astype(np.int32)))
    want = ref_gnn.forward_minibatch(
        cfg, p, [jnp.asarray(f) for f in hop_feats],
        [(jnp.asarray(s), jnp.asarray(d)) for s, d in hop_edges])
    got = gnn.forward_minibatch(
        cfg, tp, [torch.from_numpy(f) for f in hop_feats],
        [(torch.from_numpy(s), torch.from_numpy(d)) for s, d in hop_edges])
    _close(got, want, arch)


@pytest.mark.parametrize("arch", ["gatedgcn", "gin-tu"])
def test_remat_gives_the_same_gradients(arch):
    cfg = get_smoke(arch)
    feats, src, dst = _graph(np.random.default_rng(3), 50, 200, 8)
    args = (torch.from_numpy(feats), torch.from_numpy(src),
            torch.from_numpy(dst), 50)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(4), 8, 3,
                             "cpu")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, grads = api.value_and_grad(
            lambda p: gnn.forward_full(c, p, *args).square().mean(), params)
        out.append((loss, dict(_flat(grads))))
    assert torch.equal(out[0][0], out[1][0])
    for path, g in out[0][1].items():
        assert torch.equal(g, out[1][1][path]), path


# ------------------------------------------------------------ the cells --
def _shapes(shape_name):
    """(the port's shape, the reference's), minibatch_lg cut."""
    cut = MINIBATCH_CUT if shape_name == "minibatch_lg" else {}
    return (dataclasses.replace(shapes_for_family("gnn")[shape_name], **cut),
            dataclasses.replace(ref_shapes("gnn")[shape_name], **cut))


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("shape_name", GNN_SHAPES)
def test_build_cell_builds_every_gnn_cell(arch, shape_name):
    shp = shapes_for_family("gnn")[shape_name]
    cell = api.build_cell(get_config(arch), shape_name, device="cpu")
    ref_cell = ref_api.build_cell(ref_get_config(arch), shape_name)
    assert cell.kind == shp.kind == ref_cell.kind
    assert set(cell.batch_shapes) == set(ref_cell.batch_sds)
    for key, (shape, dtype) in cell.batch_shapes.items():
        want = ref_cell.batch_sds[key]
        assert tuple(shape) == tuple(want.shape), key
        assert str(dtype).split(".")[-1] == str(want.dtype), key
    assert cell.model_flops_fn() == ref_cell.model_flops_fn()
    if shape_name == "minibatch_lg":     # the padded merged subgraph
        assert cell.batch_shapes["feats"][0] == (169_984, 602)
        assert cell.batch_shapes["src"][0] == (168_960,)
    if shape_name == "ogb_products":
        assert cell.batch_shapes["feats"][0] == (2_449_408, 100)
        assert cell.batch_shapes["src"][0] == (61_859_328,)


def _gnn_batch(cell, shp, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, _) in cell.batch_shapes.items():
        if key == "adj":
            out[key] = (rng.random(shape) < 0.2).astype(np.float32)
        elif key == "feats":
            out[key] = rng.standard_normal(shape).astype(np.float32)
        elif key == "labels":        # -1: unlabelled (masked) nodes
            low = 0 if shp.kind == "dense_batch" else -1
            out[key] = rng.integers(low, shp.n_classes, shape).astype(
                np.int32)
        else:
            n = cell.batch_shapes["feats"][0][0]
            out[key] = rng.integers(0, n, shape).astype(np.int32)
    return out


def _hold_state(tstate, state, metrics, tmetrics):
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmetrics[key]), float(metrics[key]),
                                   rtol=1e-4, err_msg=key)
    got, want = dict(_flat(tstate)), dict(_flat(_np(state)))
    assert set(got) == set(want)
    for path, w in want.items():
        if path == "opt/step":
            assert int(got[path]) == int(w)
        else:
            _close(got[path], w, path)


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("shape_name",
                         ["full_graph_sm", "minibatch_lg", "molecule"])
def test_gnn_cell_two_steps_match_reference(arch, shape_name):
    shp, ref_shp = _shapes(shape_name)
    cfg, pcfg = ref_get_smoke(arch), get_smoke(arch)
    ref_cell = ref_api.build_cell(cfg, shape_name, shape_override=ref_shp)
    cell = api.build_cell(pcfg, shape_name, device="cpu", shape_override=shp)
    state = ref_api.materialize_state(ref_cell, cfg, shape_name,
                                      jax.random.PRNGKey(5))
    tstate = state_from_arrays("gnn", _np(state), "cpu")
    step = jax.jit(ref_cell.step)
    for i in range(2):
        batch = _gnn_batch(cell, shp, seed=10 + i)
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmetrics = cell.step(tstate, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        _hold_state(tstate, state, metrics, tmetrics)
    assert int(tstate["opt"]["step"]) == 2


def test_materialize_gnn_state_matches_reference_tree():
    arch, shape_name = "gatedgcn", "molecule"
    cfg = ref_get_smoke(arch)
    ref_cell = ref_api.build_cell(cfg, shape_name)
    want = _np(ref_api.materialize_state(ref_cell, cfg, shape_name,
                                         jax.random.PRNGKey(0)))
    cell = api.build_cell(get_smoke(arch), shape_name, device="cpu")
    got = api.materialize_state(cell, get_smoke(arch), shape_name,
                                torch.Generator().manual_seed(0))
    want_leaves, got_leaves = dict(_flat(want)), dict(_flat(got))
    assert set(got_leaves) == set(want_leaves)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert tuple(g.shape) == np.shape(w), path
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype), path
        if path.startswith("opt/"):
            assert not np.asarray(g).any(), path
