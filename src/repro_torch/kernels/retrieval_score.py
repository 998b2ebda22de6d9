"""MIND multi-interest retrieval scores: kernel 10 and its plain version.

``score[c] = max_i <cands[c], interests[i]>`` for candidate rows
``cands [C, D]`` and one user's interest capsules ``interests [I, D]``,
float32 → ``[C]`` float32. The recsys retrieval cell scores one user
against 10^6 candidates with it.

  retrieval_score — kernel 10 (``csrc/retrieval_score.cu``): half a warp
                per candidate row, interests in shared memory, true
                float32 FMAs. Replaces the reference's ``retrieval_score``.
  retrieval_score_plain — ``ref.retrieval_score_ref``: the product
                ``cands @ interests.T`` and its row max.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises; on a ``meta`` tensor (a dry run) it
allocates the scores, records the call in ``work.TALLY`` and launches
nothing. The kernel sums in another order than the
plain version: they agree within float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from . import _lib, ref, work
from .interval_stab import is_meta, on_cpu

retrieval_score_plain = ref.retrieval_score_ref


def retrieval_score(cands, interests):
    """Kernel 10: [C] float32 scores of cands [C, D] against interests
    [I, D] float32, I >= 1."""
    if on_cpu(cands):
        return retrieval_score_plain(cands, interests)
    rows, d = cands.shape
    n_int = interests.shape[0]
    dev = cands.device
    if n_int < 1 or d < 1:
        raise ValueError(f"retrieval_score takes I >= 1 and D >= 1, got "
                         f"interests of shape {tuple(interests.shape)}")
    if is_meta(cands):
        work.TALLY.add("retrieval_score", (cands, interests))
        return torch.empty(rows, dtype=torch.float32, device=dev)
    limit = _lib.max_smem(dev)
    if 4 * n_int * d > limit:
        raise ValueError(f"retrieval_score: interests of {4 * n_int * d} B "
                         f"exceed the {limit} B of shared memory a block "
                         f"may use")
    args = (_lib.check(cands, "cands", (rows, d), dev, dtype="float32"),
            _lib.check(interests, "interests", (n_int, d), dev,
                       dtype="float32"))
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        _lib.launch("retrieval_score", "reach_retrieval_score", dev, *args,
                    out.data_ptr(), rows, d, n_int, limit)
    return out
