"""Logical-axis placement rules (MaxText-style) over a ``launch.mesh.Mesh``.

Leaves are annotated with *logical axes* (tuples of names like ("batch",
"seq", "embed")); a rule table maps logical names to mesh axes.
``logical_to_spec`` resolves the rules with the reference's divisibility
fallback: a logical axis whose size the mesh axes do not divide drops
axes from the end of its tuple, then stays replicated (smollm's 15 heads
on a 16-wide model axis), and an axis once used is not used again.

A spec is a tuple with one entry a dimension: ``None`` (replicated), a
mesh axis name, or a tuple of names (the dimension split over their
product, the first the slowest), the reference's ``PartitionSpec`` as a
tuple. ``Placement`` (mesh, spec) is the counterpart of its
``NamedSharding``. One process holds one rank's block of a leaf, so two
functions take the place of what JAX does with a sharded array:
``local_slice`` cuts this rank's block out of the whole leaf, ``gather``
rebuilds the whole from every rank's block (all-gathers over the spec's
axes).

The reference's ``shard_map_compat`` and ``ShardingCtx.constrain`` have
no counterpart: the port writes its collectives out where the reference
lets XLA place them (``parallel.collectives``, ``models.transformer``'s
tensor-parallel layer, the train step's sums and ZeRO-1 gathers). The
functions that only read axis sizes (``mesh_axis_size``,
``logical_to_spec``, ``zero1_spec``) also take a mapping of axis name to
size in place of a mesh.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .collectives import all_gather_

MeshAxes = Union[str, Tuple[str, ...], None]

# the reference's default rule table; configs may override entries
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # data-parallel axes
    "batch": ("pod", "data"),
    "query": ("pod", "data"),          # serving query stream
    "edges": ("pod", "data"),          # GNN edge partition
    # tensor-parallel axes
    "embed": None,                      # activations' model dim: replicated
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "mlp": "model",                     # d_ff
    "vocab": "model",
    "experts": "model",                 # EP
    "kv_seq": ("data", "model"),        # long-context decode caches
    "table_rows": "model",              # recsys embedding table rows
    "nodes": ("pod", "data"),           # GNN node partition (full-graph)
    "expert_cap": "data",               # MoE expert-capacity dim
    "index_nodes": None,                # ferrari packed index rows
    "hidden": None,
    # never sharded
    "seq": None,
    "layers": None,
    "stack": None,
    "capsule": None,
    "feat": None,
}


def _sizes(mesh) -> Mapping:
    return mesh if isinstance(mesh, Mapping) else mesh.sizes


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Sequence[MeshAxes]) -> Tuple[str, ...]:
    """Every mesh axis that ``spec`` splits a dimension over."""
    return tuple(a for entry in spec for a in _axes(entry))


def mesh_axis_size(mesh, axes: MeshAxes) -> int:
    sizes = _sizes(mesh)
    size = 1
    for a in _axes(axes):
        size *= sizes[a]
    return size


def logical_to_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                    mesh, rules: Optional[Dict[str, MeshAxes]] = None
                    ) -> tuple:
    """Resolve logical axis names to a spec with divisibility fallback.
    ``logical`` entries may be None (replicated)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    sizes = _sizes(mesh)

    def prod(axes):
        return int(np.prod([sizes[a] for a in axes]))
    used: set = set()
    spec = []
    for name, dim in zip(logical, shape):
        tgt = rules.get(name) if name is not None else None
        if tgt is None:
            spec.append(None)
            continue
        # drop axes not present in this mesh (e.g. 'pod' on single-pod)
        axes = tuple(a for a in _axes(tgt) if a in sizes and a not in used)
        size = prod(axes) if axes else 1
        if not axes or size == 1 or dim % size != 0:
            # divisibility fallback: try a prefix of the axes tuple
            while axes and dim % prod(axes) != 0:
                axes = axes[:-1]
            if not axes:
                spec.append(None)
                continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def zero1_spec(spec: Sequence[MeshAxes], shape: Sequence[int],
               mesh) -> tuple:
    """ZeRO-1: additionally shard an optimizer-state leaf over the data
    axes on the first unsharded, divisible dimension."""
    sizes = _sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set(spec_axes(entries))
    dp_axes = tuple(a for a in ("pod", "data")
                    if a in sizes and a not in used)
    if not dp_axes:
        return tuple(spec)
    size = int(np.prod([sizes[a] for a in dp_axes]))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % size == 0 and dim > 0:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            return tuple(entries)
        if e is None and len(dp_axes) > 1 and dim % sizes[dp_axes[-1]] == 0:
            entries[i] = dp_axes[-1]
            return tuple(entries)
    return tuple(spec)


@dataclass(frozen=True)
class Placement:
    """Where the blocks of a leaf live: ``mesh`` (a ``launch.mesh.Mesh``)
    and ``spec``; the reference's ``NamedSharding``."""
    mesh: Any
    spec: tuple


def named_sharding(logical, shape, mesh, rules=None) -> Placement:
    return Placement(mesh, logical_to_spec(logical, shape, mesh, rules))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_shardings(logical_tree, shape_tree, mesh, rules=None):
    """Matching trees (dicts, lists) of logical-axis tuples and of shapes
    (tensors, or anything with ``.shape``, or tuples of ints) mapped to a
    tree of ``Placement``."""
    if _is_logical(logical_tree):
        return named_sharding(logical_tree, _shape_of(shape_tree), mesh,
                              rules)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(v, shape_tree[k], mesh, rules)
                for k, v in logical_tree.items()}
    return [tree_shardings(v, s, mesh, rules)
            for v, s in zip(logical_tree, shape_tree)]


def _blocks(spec: Sequence[MeshAxes], shape: Sequence[int], mesh) -> list:
    """(dim, start, length) of this rank's block on each dimension that
    ``spec`` splits over more than one rank."""
    out = []
    for dim, entry in enumerate(spec):
        n = mesh.size(entry) if entry is not None else 1
        if n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {n} ranks ({entry})")
        b = shape[dim] // n
        out.append((dim, mesh.index(entry) * b, b))
    return out


def local_shape(shape: Sequence[int], spec: Sequence[MeshAxes],
                mesh) -> tuple:
    """The shape of this rank's block of a leaf of ``shape``."""
    out = list(shape)
    for dim, _, b in _blocks(spec, shape, mesh):
        out[dim] = b
    return tuple(out)


def local_slice(whole: torch.Tensor, spec: Sequence[MeshAxes],
                mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``whole`` under ``spec`` (a
    view)."""
    out = whole
    for dim, start, b in _blocks(spec, whole.shape, mesh):
        out = out.narrow(dim, start, b)
    return out


def gather(local: torch.Tensor, spec: Sequence[MeshAxes],
           mesh) -> torch.Tensor:
    """The whole leaf from every rank's block ``local`` under ``spec``:
    an all-gather over the axes of each split dimension, the blocks in
    mesh order. Every rank of those groups must call it."""
    out = local
    for dim, entry in enumerate(spec):
        if entry is None or mesh.size(entry) == 1:
            continue
        out = all_gather_(out, mesh.group(entry), dim, mesh.members(entry),
                          name="gather")
    return out
