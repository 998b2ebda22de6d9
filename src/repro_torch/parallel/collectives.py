"""The two differentiable collectives of the expert-parallel MoE FFN and
the train step's plain sum, over a ``torch.distributed`` process group.

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
gradient behind it by the group's size. A group of ``None`` stands for
a group of one rank (``core.distributed.ServingMesh`` creates none): both
are then identities and nothing is launched. ``CALLS`` counts the
all-reduces issued, by the function that issued them.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

CALLS: Counter = Counter()


def all_reduce_(t: torch.Tensor, group, name: str = "all_reduce"):
    """Sum ``t`` over ``group`` in place (not differentiated); counted
    under ``name``. Returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        CALLS[name] += 1
    return t


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


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor); its gradient passed
    through as it is."""
    return x if group is None else _SumOverGroup.apply(x, group)
