"""The yardstick's reckoning of a kernel's work, and the card's peaks.

``stab_packed`` is a frozen copy of the port's ``kernels/work.py``
reckoning of kernel 1 (``csrc/interval_stab.cu``): the bytes one call must
move and the int32 operations it must do, on that call's pairs. Each input
the verdicts depend on is read once (a pair's two ids, the meta row of
each distinct id, the slab row of each distinct source), each verdict is
written once, and pairs with s == t, which the kernel answers without a
lookup, count only their ids and verdict. The pairs are the window's
original ids: the port gathers its condensed ids through ``comp``, which
is one to one on a DAG, so the distinct counts are the same. ``k`` is the
configuration's ``k_max``, the interval slots a node.

``PEAKS``: the published peaks of each card by the name
``torch.cuda.get_device_name`` gives (NVIDIA's data sheet, SXM part, at
the full 700 W power limit): HBM bytes a second, and int32 operations a
second outside the tensor cores.
"""
from __future__ import annotations

import numpy as np

PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "int_ops_per_s": 67e12}}

KERNEL1 = ("stab_packed_one", "stab_packed_kernel")


def stab_packed(cs: np.ndarray, ct: np.ndarray, k: int) -> tuple:
    """(bytes, ops) of one kernel-1 call on pairs ``cs`` → ``ct``."""
    q = cs.size
    keep = cs != ct
    s, t = cs[keep], ct[keep]
    live = int(keep.sum())
    both = np.unique(np.concatenate([s, t])).size
    src = np.unique(s).size
    return q * 12 + both * 16 + src * 8 * k, live * (6 * k + 25) + q


def bound_s(bytes_: int, ops: int, peaks: dict) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(bytes_ / peaks["bytes_per_s"], ops / peaks["int_ops_per_s"])
