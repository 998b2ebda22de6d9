"""Collectives over ``torch.distributed`` process groups that autograd
differentiates as ``shard_map`` does the reference's (see
``collectives``)."""
from .collectives import CALLS, all_reduce_, copy_to_group, sum_over_group

__all__ = ["CALLS", "all_reduce_", "copy_to_group", "sum_over_group"]
