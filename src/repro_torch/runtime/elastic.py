"""Elastic scaling: re-mesh over the surviving ranks + state resharding.

On a real cluster the runtime learns the surviving set from the
coordinator after a node failure (or a resize request). This module owns
the two decisions that follow, as the reference's does:

  1. ``plan_mesh_shape(n, ...)`` — the largest well-formed (pod, data,
     model) mesh the survivors can form. The model axis keeps its width
     while it can (TP resharding moves every weight; DP resharding only
     re-slices the batch and the optimizer blocks), then degrades.
  2. ``reshard(tree, placements, old)`` — move a state from one mesh's
     blocks to another's: gather each leaf whole under its old placement,
     keep this rank's block under the new one.

The port's meshes are grids of ranks, one process a device
(``launch.mesh.Mesh``), where the reference's are grids of JAX devices of
one process: ``ElasticMeshManager`` tracks ranks, ``devices_of_worker``
gives a worker's contiguous block of ranks, and ``current_mesh`` lays
the survivors out. Creating a mesh creates process groups, which every
rank of the default group must do in the same order, so every rank calls
``current_mesh`` after an ``exclude`` (the excluded ranks too, which are
outside the mesh it returns) before an excluded rank leaves the training
loop. The failure is simulated, as the reference's is
(``runtime.fault_tolerance.FaultInjector``): every process is still
alive. A process that really crashed leaves its process group unusable,
and needs the group restarted around the survivors (torchrun's elastic
agent), which the reference does not model either.

The Trainer (``launch.train.Trainer``) uses these after a failure:
exclude → ``current_mesh`` → ``build_cell(mesh=new)`` → restore the last
committed checkpoint onto the new mesh → resume.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..checkpoint.checkpoint import _flatten_with_paths, _tree_map
from ..launch.mesh import Mesh, _world
from ..parallel.sharding import gather, local_slice


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_mesh_shape(n_devices: int, prefer_model: int = 16,
                    multi_pod: bool = False) -> Tuple[Tuple[int, ...],
                                                      Tuple[str, ...]]:
    """Largest usable mesh shape from ``n_devices`` survivors.

    Keeps the model axis at ``prefer_model`` while the survivor count
    allows a non-trivial data axis; otherwise halves the model axis until
    it fits. Uses the largest power-of-two device count (ragged survivor
    sets waste the remainder — the standard trade on real pods, where the
    scheduler backfills later).
    """
    usable = _largest_pow2_leq(n_devices)
    model = min(prefer_model, usable)
    while model > 1 and usable // model < 1:
        model //= 2
    rest = usable // model
    if multi_pod and rest >= 4:
        return (2, rest // 2, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def make_mesh_from_devices(devices: Sequence[int], shape: Tuple[int, ...],
                           axes: Tuple[str, ...], device="cuda") -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) ranks of
    ``devices`` (every rank of the default group must call it)."""
    n = int(np.prod(shape))
    return Mesh(shape, axes, ranks=list(devices)[:n], device=device)


@dataclass
class ElasticMeshManager:
    """Tracks the live ranks and produces successive meshes.

    ``exclude(ranks)`` removes failed/straggler ranks; ``current_mesh``
    lays the largest mesh over the survivors (None for one survivor or
    none). ``generation`` increments on every exclusion so checkpoints
    can record which mesh wrote them. Needs an initialised process group
    (``RuntimeError`` otherwise); ``device`` is every mesh's.
    """
    prefer_model: int = 16
    multi_pod: bool = False
    device: str = "cuda"
    generation: int = 0
    _dead: set = field(default_factory=set)
    _devices: List[int] = field(default_factory=list)

    def __post_init__(self):
        self._devices = list(range(_world()))

    @property
    def alive(self) -> List[int]:
        return [r for r in self._devices if r not in self._dead]

    def is_alive(self, rank: Optional[int] = None) -> bool:
        """Whether ``rank`` (default: this process's) survives."""
        return (dist.get_rank() if rank is None else rank) in self.alive

    def exclude(self, device_ids: Sequence[int]):
        self._dead.update(int(i) for i in device_ids)
        self.generation += 1

    def devices_of_worker(self, worker: int, n_workers: int) -> List[int]:
        """Ranks hosted by ``worker`` (contiguous block assignment — the
        standard host → devices mapping)."""
        per = max(1, len(self._devices) // max(n_workers, 1))
        return self._devices[worker * per:(worker + 1) * per]

    def current_mesh(self) -> Optional[Mesh]:
        alive = self.alive
        if len(alive) <= 1:
            return None                      # single device: no mesh needed
        shape, axes = plan_mesh_shape(len(alive), self.prefer_model,
                                      self.multi_pod)
        return make_mesh_from_devices(alive, shape, axes, self.device)


def reshard(tree, placements, old_placements):
    """Move a state of this rank's blocks under ``old_placements`` onto
    ``placements`` (trees of ``parallel.sharding.Placement`` matching
    ``tree``; a None placement keeps the leaf whole): each leaf gathered
    whole over its old mesh (every rank of it takes part), then this
    rank's block under the new one kept (None where this rank is not in
    the new mesh)."""
    new = dict(_flatten_with_paths(placements))
    old = dict(_flatten_with_paths(old_placements))
    paths = iter(p for p, _ in _flatten_with_paths(tree))

    def one(leaf):
        path = next(paths)
        if old.get(path) is not None:
            leaf = gather(leaf, old[path].spec, old[path].mesh)
        p = new.get(path)
        if p is None:
            return leaf
        if not p.mesh.member:
            return None
        part = local_slice(leaf, p.spec, p.mesh)
        return part if part.shape == leaf.shape else part.clone()
    return _tree_map(one, tree)
