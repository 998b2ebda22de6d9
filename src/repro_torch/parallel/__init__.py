"""Collectives over ``torch.distributed`` process groups that autograd
differentiates as ``shard_map`` does the reference's (``collectives``),
the logical-axis placement of a leaf over a mesh (``sharding``) and the
GPipe forward over a mesh axis (``pipeline``)."""
from .collectives import (BYTES, CALLS, KIND_BYTES, KINDS, all_gather_,
                          all_reduce_, copy_to_group, gather_from_group,
                          sum_over_group)

__all__ = ["BYTES", "CALLS", "KIND_BYTES", "KINDS", "all_gather_",
           "all_reduce_", "copy_to_group", "gather_from_group",
           "sum_over_group"]
