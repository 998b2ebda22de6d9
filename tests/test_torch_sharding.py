"""The port's placement rules (``parallel.sharding``) and elastic mesh
planning (``runtime.elastic.plan_mesh_shape``) against the reference's.

The reference's ``mesh_axis_size``, ``logical_to_spec`` and
``zero1_spec`` read only ``mesh.shape``, so they are called with a
stand-in whose ``shape`` is the axis dict; the port's take the dict
itself. Over every leaf's logical axes of the four LM archs (published
and SMOKE widths), the decode cache's, the batch's and a few GNN and
recsys tuples, on (data, model) and (pod, data, model) meshes from 1x1 to
2x16x16, with the default rules and with overrides, both give the same
specs (the reference's ``PartitionSpec`` as a tuple), and ZeRO-1 adds
the data axes on the same dimension. ``plan_mesh_shape`` gives the same
answer for every survivor count 1..1024, multi-pod or not, at every
preferred model width. The meshes need a process group and raise
``RuntimeError`` without one.
"""
import itertools
from types import SimpleNamespace

import pytest

from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.models import transformer as ref_tf
from repro.parallel import sharding as ref_shd
from repro.runtime.elastic import _largest_pow2_leq as ref_pow2
from repro.runtime.elastic import plan_mesh_shape as ref_plan
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.elastic import (ElasticMeshManager,
                                         _largest_pow2_leq, plan_mesh_shape)

ARCHS = ("tinyllama-1.1b", "smollm-360m", "moonshot-v1-16b-a3b",
         "phi3.5-moe-42b-a6.6b", "llama3-8b")
MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 1},
          {"data": 1, "model": 2}, {"data": 2, "model": 2},
          {"data": 4, "model": 8}, {"data": 16, "model": 16},
          {"pod": 2, "data": 1, "model": 2}, {"pod": 2, "data": 2, "model": 4},
          {"pod": 2, "data": 16, "model": 16})
RULES = (None, {"mlp": "data"}, {"heads": ("data", "model"), "embed": "data"},
         {"vocab": None, "batch": "data"})
# logical tuples off the LM params: activations, caches, GNN and recsys
EXTRA = [(("batch", "seq", "embed"), (4, 32, 2048)),
         (("batch", None), (256, 4096)), (("batch", None), (3, 7)),
         (("layers", "batch", "kv_seq", "kv_heads", None),
          (22, 1, 32768, 4, 64)),
         (("layers", "batch", "kv_seq", "kv_heads"), (32, 128, 32768, 8)),
         (("nodes", None), (2449408, 100)), (("edges",), (61859328,)),
         (("table_rows", "embed"), (8388608, 64)),
         (("experts", "expert_cap", "embed"), (64, 48, 2048)),
         (("batch", "seq", "heads", None), (2, 4096, 15, 64)), ((), ())]


def _leaves(cfg):
    """(logical axes, shape) of every leaf of ``cfg``'s params."""
    log, shp = tf.param_logical_axes(cfg), tf.param_shapes(cfg)
    out = []
    for k, v in log.items():
        if k == "layers":
            out += [(v[n], shp["layers"][n]) for n in v]
        else:
            out.append((v, shp[k]))
    return out


def _cases():
    out = list(EXTRA)
    for arch in ARCHS:
        for cfg in (get_config(arch), get_smoke(arch)):
            out += _leaves(cfg)
    return out


def _ids(m):
    return "x".join(f"{k}{v}" for k, v in m.items())


def test_param_axes_and_shapes_are_the_reference_ones():
    for arch in ARCHS:
        for ref, cfg in ((ref_get_config(arch), get_config(arch)),
                         (ref_get_smoke(arch), get_smoke(arch))):
            assert tf.param_logical_axes(cfg) == ref_tf.param_logical_axes(
                ref)
            want = ref_tf.abstract_params(ref)
            got = tf.param_shapes(cfg)
            assert got.keys() == want.keys()
            for k in got:
                if k == "layers":
                    assert {n: tuple(s.shape) for n, s in
                            want[k].items()} == got[k]
                else:
                    assert tuple(want[k].shape) == got[k]


@pytest.mark.parametrize("sizes", MESHES, ids=_ids)
def test_specs_match_the_reference(sizes):
    """``logical_to_spec`` (every rule table), ``zero1_spec`` on its
    result and ``mesh_axis_size`` of every axis tuple."""
    stand_in = SimpleNamespace(shape=dict(sizes))
    for rules in RULES:
        for logical, shape in _cases():
            want = ref_shd.logical_to_spec(logical, shape, stand_in, rules)
            got = shd.logical_to_spec(logical, shape, sizes, rules)
            assert got == tuple(want), (logical, shape, rules)
            z_want = ref_shd.zero1_spec(want, shape, stand_in)
            assert shd.zero1_spec(got, shape, sizes) == tuple(z_want), (
                logical, shape, rules)
    for k in range(len(sizes) + 1):
        for axes in itertools.permutations(sizes, k):
            for a in (axes, axes[0] if len(axes) == 1 else axes):
                assert shd.mesh_axis_size(sizes, a) == \
                    ref_shd.mesh_axis_size(stand_in, a)
    assert shd.mesh_axis_size(sizes, None) == 1


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_mesh_shape_matches_the_reference(multi_pod):
    for n in range(1, 1025):
        assert _largest_pow2_leq(n) == ref_pow2(n)
        for prefer in (1, 2, 4, 16, 64):
            assert plan_mesh_shape(n, prefer, multi_pod) == \
                ref_plan(n, prefer, multi_pod), (n, prefer)


def test_plan_mesh_shape_degrades_gracefully():
    """The reference test's own cases."""
    assert plan_mesh_shape(256) == ((16, 16), ("data", "model"))
    assert plan_mesh_shape(248) == ((8, 16), ("data", "model"))
    assert plan_mesh_shape(8, prefer_model=16) == ((1, 8), ("data", "model"))
    assert plan_mesh_shape(3, prefer_model=16) == ((1, 2), ("data", "model"))
    shape, axes = plan_mesh_shape(512, multi_pod=True)
    assert shape == (2, 16, 16) and axes == ("pod", "data", "model")


def test_meshes_need_a_process_group():
    """No fallback: without torch.distributed there is no mesh."""
    for make in (lambda: Mesh((1, 1), ("data", "model"), device="cpu"),
                 lambda: make_debug_mesh(device="cpu"),
                 lambda: make_production_mesh(device="cpu"),
                 lambda: ElasticMeshManager(prefer_model=2, device="cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            make()


def test_tree_shardings_and_placement():
    """``tree_shardings`` maps a state's logical tree to placements whose
    specs are ``logical_to_spec``'s; a stand-in mesh of sizes serves."""
    cfg = get_smoke("tinyllama-1.1b")
    sizes = {"data": 2, "model": 2}
    out = shd.tree_shardings(tf.param_logical_axes(cfg), tf.param_shapes(cfg),
                             sizes)
    assert out["embed"] == shd.Placement(sizes, ("model", None))
    assert out["layers"]["wq"].spec == (None, None, "model")
    assert out["layers"]["wo"].spec == (None, "model", None)
    assert out["final_norm"].spec == (None,)
