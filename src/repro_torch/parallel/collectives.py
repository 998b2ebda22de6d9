"""The collectives of the port's model paths over ``torch.distributed``
process groups: the differentiable pair of the expert-parallel MoE FFN
and of the dense layer's tensor parallelism, the differentiable gather
that re-slices a weight whose stored block is not the one a rank needs,
and the plain sums and gathers of the train step.

The reference runs the FFN inside ``shard_map`` and sums the partial
combine with ``psum``; JAX transposes both on its own. Here the pair is
written out:

  * ``copy_to_group`` — identity forward, sum over the group in the
    backward: an input replicated over the group (the activations, the
    router) whose gradient each rank holds only in part.
  * ``sum_over_group`` — ``all_reduce`` forward, identity backward: the
    combine, whose cotangent is the same on every rank of the group.

``torch.distributed.nn.functional.all_reduce`` is not the second one:
its backward sums the cotangent over the group again, which scales every
gradient behind it by the group's size.

  * ``gather_from_group`` — ``all_gather`` forward, the gradient of the
    whole summed over the group (or, where every rank computes the same
    from the whole, taken as it is) and cut to this rank's block
    backward.

A group of ``None`` stands for a group of one rank (``launch.mesh.Mesh``
creates none): every function here is then the identity and nothing is
launched. ``CALLS`` counts the collectives made, by the function that
made them, and ``BYTES`` their payload bytes (each rank's tensor).
``KINDS`` counts them by the reference's HLO kind ("all-reduce",
"all-gather", "collective-permute" for a send or a receive) and
``KIND_BYTES`` the bytes of each kind's result on this rank (an
all-gather's whole output), as the reference's dry run sums the result
shapes of the collectives in its partitioned program. ``reset()`` clears
all four.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

CALLS: Counter = Counter()
BYTES: Counter = Counter()
KINDS: Counter = Counter()
KIND_BYTES: Counter = Counter()


def reset() -> None:
    for c in (CALLS, BYTES, KINDS, KIND_BYTES):
        c.clear()


def _count(name: str, t: torch.Tensor, kind: str = "all-reduce",
           parts: int = 1) -> None:
    """Count one collective under ``name`` and ``kind``: ``t`` this rank's
    tensor, ``parts`` the blocks its result holds (an all-gather's group
    size)."""
    nbytes = t.numel() * t.element_size()
    CALLS[name] += 1
    BYTES[name] += nbytes
    KINDS[kind] += 1
    KIND_BYTES[kind] += nbytes * parts


def all_reduce_(t: torch.Tensor, group, name: str = "all_reduce",
                op=dist.ReduceOp.SUM):
    """Reduce ``t`` over ``group`` in place with ``op`` (default: sum;
    not differentiated); counted under ``name``. Returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
        _count(name, t)
    return t


def all_gather_(t: torch.Tensor, group, dim: int = 0, ranks=None,
                name: str = "all_gather") -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along ``dim`` (not
    differentiated): in the order of the global ranks ``ranks`` where
    given (a mesh's block order), else in group-rank order."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    _count(name, t, "all-gather", len(parts))
    if ranks is not None:
        order = dist.get_process_group_ranks(group)
        parts = [parts[order.index(r)] for r in ranks]
    return torch.cat(parts, dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group,
                           "copy_to_group"), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group, "sum_over_group")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, ranks, index, partial):
        ctx.group, ctx.dim, ctx.index = group, dim, index
        ctx.block, ctx.partial = x.shape[dim], partial
        return all_gather_(x, group, dim, ranks, "gather_from_group")

    @staticmethod
    def backward(ctx, grad):
        whole = grad
        if ctx.partial:
            whole = all_reduce_(grad.contiguous().clone(), ctx.group,
                                "gather_from_group")
        return (whole.narrow(ctx.dim, ctx.index * ctx.block, ctx.block),
                None, None, None, None, None)


def gather_from_group(x: torch.Tensor, group, dim: int, ranks,
                      index: int, partial: bool = True) -> torch.Tensor:
    """The whole of a leaf sharded over ``group`` along ``dim``: the
    blocks of the global ranks ``ranks`` in that order, this rank's at
    position ``index``; the gradient of the whole, which each rank holds
    only in part, summed over the group and cut to this rank's block.
    ``partial`` False: every rank of the group computes the same thing
    from the whole, so each holds the whole gradient, which is only
    cut."""
    if group is None:
        return x
    return _GatherFromGroup.apply(x, group, dim, ranks, index, partial)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor); its gradient passed
    through as it is."""
    return x if group is None else _SumOverGroup.apply(x, group)
