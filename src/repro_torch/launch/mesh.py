"""Meshes over the ranks of a ``torch.distributed`` process group.

The reference's mesh is a grid of JAX devices that one process drives;
here it is a grid of ranks, one process a device. ``Mesh(shape,
axis_names, ranks)`` lays ``ranks`` (default: the first prod(shape)
ranks of the initialised group) out row-major over the named axes: the
rank at position r of ``ranks`` sits at ``unravel_index(r, shape)``. It
holds its shape, this rank's coordinates (None where the rank is not in
the mesh, as an excluded worker's after an elastic re-mesh), its device,
and a process group for every non-empty tuple of axes (``("pod",
"data")`` and ``("data", "model")`` included): the ranks that share this
rank's coordinates on every other axis. Every rank of the default group
creates every group in the same order, as ``torch.distributed.new_group``
requires, members of the mesh or not. A group of one rank is not created
and stands as ``None``: a collective over it is the identity.

Single pod: 16x16 = 256 ranks, axes (data, model); multi-pod: 2 pods =
512 ranks, axes (pod, data, model). ``make_debug_mesh`` takes whatever
ranks the group has. The reference's ``make_mesh_compat`` is a shim over
JAX versions and has no counterpart.

A mesh needs an initialised process group and raises ``RuntimeError``
without one; the caller picks the backend (NCCL between cards, gloo on
the CPU or for ranks that share one card). ``core.distributed.
ServingMesh`` is the (data, model) case of this type.
"""
from __future__ import annotations

from itertools import combinations, product
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from ..core.query_torch import resolve_device

Axes = Union[str, Tuple[str, ...], None]


def _world() -> int:
    """The size of the initialised process group; ``RuntimeError``
    without one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh lays out the ranks of torch.distributed: initialise "
            "the process group first (torchrun, or init_process_group "
            "with this rank's world and rank)")
    return dist.get_world_size()


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """``shape`` (sizes, in ``axis_names`` order) over ``ranks``. The
    reference's ``mesh.shape[axis]`` is ``sizes[axis]`` here; ``shape``
    is the tuple of sizes, as a checkpoint's manifest records it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None, device="cuda"):
        world = _world()
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if (len(shape) != len(axis_names) or min(shape, default=0) < 1
                or len(set(axis_names)) != len(axis_names)):
            raise ValueError(f"bad mesh {shape} over axes {axis_names}")
        n = int(np.prod(shape))
        ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        if len(ranks) != n:
            raise ValueError(f"mesh {shape} needs {n} ranks, given "
                             f"{len(ranks)}")
        if len(set(ranks)) != n or not all(0 <= r < world for r in ranks):
            raise ValueError(f"ranks {ranks} are not distinct ranks of a "
                             f"world of {world}")
        self.shape = shape
        self.axis_names = axis_names
        self.sizes: Dict[str, int] = dict(zip(axis_names, shape))
        self.ranks = tuple(ranks)
        self.world, self.rank = world, dist.get_rank()
        self.member = self.rank in self.ranks
        self.coords = (dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.ranks.index(self.rank), shape)))) if self.member else None)
        self.device = resolve_device(device)
        self._groups: dict = {}
        self._make_groups()

    # ------------------------------------------------------------- groups
    def _members(self, axes: Tuple[str, ...], at: dict) -> list:
        """The ranks that share ``at``'s coordinates off ``axes``, in the
        order of their raveled coordinate over ``axes``."""
        grid = np.asarray(self.ranks).reshape(self.shape)
        idx = []
        for a in self.axis_names:
            idx.append(slice(None) if a in axes else at[a])
        block = grid[tuple(idx)]
        kept = [a for a in self.axis_names if a in axes]
        order = [kept.index(a) for a in axes]
        return [int(r) for r in np.transpose(block, order).reshape(-1)]

    def _make_groups(self):
        made: dict = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in combinations(self.axis_names, k):
                if int(np.prod([self.sizes[a] for a in axes])) == 1:
                    continue
                rest = [a for a in self.axis_names if a not in axes]
                for fixed in product(*(range(self.sizes[a]) for a in rest)):
                    at = dict(zip(rest, fixed))
                    members = tuple(sorted(self._members(axes, at)))
                    if members not in made:
                        made[members] = dist.new_group(list(members))
                    if self.member and self.rank in members:
                        self._groups[frozenset(axes)] = made[members]

    def group(self, axes: Axes):
        """This rank's process group over ``axes``, or None for a group of
        one rank."""
        axes = _as_axes(axes)
        if self.size(axes) == 1:
            return None
        self._check_member()
        return self._groups[frozenset(axes)]

    def members(self, axes: Axes) -> list:
        """The global ranks of this rank's group over ``axes``, in block
        order (the raveled coordinate over ``axes`` as given)."""
        self._check_member()
        return self._members(_as_axes(axes), self.coords)

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (1 for None)."""
        return int(np.prod([self.sizes[a] for a in _as_axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's raveled coordinate over ``axes``, in the order
        given: its block of a dimension that ``axes`` shard."""
        self._check_member()
        i = 0
        for a in _as_axes(axes):
            i = i * self.sizes[a] + self.coords[a]
        return i

    def _check_member(self):
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in {self!r}")

    # ------------------------------------------- (pod, data, model) names
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """The data-parallel axes present: ("pod", "data")."""
        return tuple(a for a in ("pod", "data") if a in self.sizes)

    @property
    def n_data(self) -> int:
        return self.sizes.get("data", 1)

    @property
    def n_model(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def d(self) -> int:
        return self.coords.get("data", 0) if self.member else 0

    @property
    def m(self) -> int:
        return self.coords.get("model", 0) if self.member else 0

    @property
    def model_group(self):
        return self.group("model") if "model" in self.sizes else None

    @property
    def data_group(self):
        return self.group("data") if "data" in self.sizes else None

    def __repr__(self) -> str:
        at = (f"rank {self.rank} at {tuple(self.coords.values())}"
              if self.member else f"rank {self.rank} outside")
        return (f"Mesh({dict(self.sizes)}, ranks {list(self.ranks)}, {at}, "
                f"{self.device})")


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The 16x16 (data, model) mesh, or 2x16x16 (pod, data, model) with
    ``multi_pod``: the world must be 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, world = int(np.prod(shape)), _world()
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{n} ranks, the process group has {world}")
    return Mesh(shape, axes, device=device)


def make_debug_mesh(n_devices: Optional[int] = None, model: int = 1,
                    device="cuda") -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` ranks (default:
    all of them), ``model`` wide."""
    n = n_devices or _world()
    if model < 1 or n % model:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model}")
    return Mesh((n // model, model), ("data", "model"), ranks=range(n),
                device=device)
