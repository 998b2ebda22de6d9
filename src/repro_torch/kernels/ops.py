"""The entry points the engine uses, over a ``PackedIndex.to_torch`` dict.

Each op dispatches by the tensors' device only: on the CPU the kernels'
plain PyTorch versions run; on a CUDA device the hand-written kernels
launch, or the call raises. No option selects the plain versions while a
card is present.
"""
from __future__ import annotations

import torch

from . import ref
from .frontier_fused import (classify_emit, emit_plain,
                             expand_frontier_loop_fused)
from .interval_stab import stab_naive, stab_packed

NEG, POS, UNKNOWN = ref.NEG, ref.POS, ref.UNKNOWN


def classify_queries(dev: dict, cs, ct):
    """Phase-1 verdict [Q] int32 of condensed-id pairs (cs, ct) [Q] int32,
    cs == ct folded to POS. Kernel 1 on the fused slab/meta layout,
    kernel 2 on the 12-array layout."""
    if "slab" in dev:
        return stab_packed(dev["meta"], dev["slab"], cs, ct)
    sp, sm = ref.naive_seed_rows(dev)
    return stab_naive(dev["pi"], dev["tau"], dev["blevel"], dev["begins"],
                      dev["ends"], dev["exact"], sp, sm, cs, ct)


def classify_all_nodes_vs_target(dev: dict, ct):
    """Dense phase-2 helper: classify EVERY node u against each target of
    ``ct`` [Q] through the phase-1 kernel on the [Q·n] pairs. Returns
    (expandable [Q, n] bool, definite_pos [Q, n] bool): expandable nodes
    have an approximate hit and pass every negative filter; reaching a
    definite-positive node (exact hit, seed-positive, or u == t) proves
    the query."""
    n, q = dev["pi"].shape[0], ct.shape[0]
    cs_all = torch.arange(n, dtype=torch.int32, device=ct.device).repeat(q)
    v = classify_queries(dev, cs_all, ct.repeat_interleave(n)).view(q, n)
    return v == UNKNOWN, v == POS


def expand_frontier(dev: dict, ell, tail_src, tail_dst, is_hub, cs, ct,
                    pad, *, max_steps: int, cap: int):
    """Sparse phase-2 expansion of one chunk of UNKNOWN queries over the
    ELL + tail layout, on one device: (pos [Q] bool, overflow bool).
    Under overflow, positives are sound and the caller retries the rest
    with a larger cap. The chunk is bounded by ``frontier.max_batch(n)``.

    The fused layout classifies survivors with kernel 4 on their gathered
    meta/slab rows; the 12-array layout (multi-word seeds or n > 2**24)
    classifies them with kernel 2, which gathers its own rows, followed
    by the same emit rule."""
    if "slab" in dev:
        meta, slab = dev["meta"], dev["slab"]

        def fetch_rows(cands, tgts):
            c, t = cands.long(), tgts.long()
            return meta[c], meta[t], slab[c]
        classify = classify_emit
    else:
        sp, sm = ref.naive_seed_rows(dev)
        tables = (dev["pi"], dev["tau"], dev["blevel"], dev["begins"],
                  dev["ends"], dev["exact"], sp, sm)

        def fetch_rows(cands, tgts):
            return cands, tgts

        def classify(cands, tgts, keys, eq):
            # kernel 2 folds cands == tgts to POS itself (eq)
            return emit_plain(stab_naive(*tables, cands, tgts), keys)
    return expand_frontier_loop_fused(
        ell, tail_src, tail_dst, is_hub, cs, ct, pad,
        n_nodes=ell.shape[0], max_steps=max_steps, cap=cap,
        gather_rows=lambda table, ids: table[ids.long()],
        fetch_rows=fetch_rows, classify=classify)
