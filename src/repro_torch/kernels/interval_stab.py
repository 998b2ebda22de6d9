"""Phase-1 interval-stab classification: kernels 1 and 2 and their plain
versions.

Per query (s, t) of condensed ids: test π(t) against the source's interval
slab, with the topological-order filter (Eq. 11), the level filter (§5.2)
and the seed rules (§5.1), plus the s == t early positive. Verdicts are
int32 in {0 NEG, 1 POS, 2 UNKNOWN}.

  stab_packed — kernel 1 (``csrc/interval_stab.cu``), the gather-fused
                layout: ``meta [n, 4]`` and ``slab [n, 2K]``. Replaces the
                reference's ``interval_stab_classify_packed``.
  stab_naive  — kernel 2, the 12-array layout with W-word seeds and
                unsaturated levels (used when the fused layout does not
                fit). Replaces the reference's ``interval_stab_classify``.

Unlike the reference, which gathers the rows in XLA and streams them into
the kernel, both kernels take the tables and the (cs, ct) ids and do the
row gathers themselves; ids must lie in [0, n). On a CPU tensor a wrapper
runs its plain version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _lib, ref


def on_cpu(t) -> bool:
    """True for a CPU tensor, False for a CUDA one; other devices raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def stab_packed_plain(meta, slab, cs, ct):
    s, t = cs.long(), ct.long()
    v = ref.interval_stab_classify_packed_ref(meta[s], meta[t], slab[s])
    return torch.where(cs == ct, ref.POS, v).to(torch.int32)


def stab_packed(meta, slab, cs, ct):
    """Kernel 1: verdict [Q] int32 of (cs, ct) on the fused layout."""
    if on_cpu(cs):
        return stab_packed_plain(meta, slab, cs, ct)
    n, q, k2 = meta.shape[0], cs.shape[0], slab.shape[1]
    dev = cs.device
    args = (_lib.check(meta, "meta", (n, 4), dev, align=16),
            _lib.check(slab, "slab", (n, k2), dev),
            _lib.check(cs, "cs", (q,), dev),
            _lib.check(ct, "ct", (q,), dev))
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        _lib.launch("stab_packed", "reach_stab_packed", dev, *args,
                    out.data_ptr(), q, k2 // 2)
    return out


def stab_naive_plain(pi, tau, blevel, begins, ends, exact, s_plus, s_minus,
                     cs, ct):
    s, t = cs.long(), ct.long()
    v = ref.interval_stab_classify_ref(
        pi[t], tau[s], tau[t], blevel[s], blevel[t],
        begins[s], ends[s], exact[s],
        s_plus[s], s_minus[s], s_plus[t], s_minus[t])
    return torch.where(cs == ct, ref.POS, v).to(torch.int32)


def stab_naive(pi, tau, blevel, begins, ends, exact, s_plus, s_minus,
               cs, ct):
    """Kernel 2: verdict [Q] int32 of (cs, ct) on the 12-array layout.
    ``s_plus``/``s_minus`` are [n, W] int32 views of the seed words, with
    W = 0 when the index has no seeds."""
    if on_cpu(cs):
        return stab_naive_plain(pi, tau, blevel, begins, ends, exact,
                                s_plus, s_minus, cs, ct)
    n, q = pi.shape[0], cs.shape[0]
    k, w = begins.shape[1], s_plus.shape[1]
    dev = cs.device
    args = (_lib.check(pi, "pi", (n,), dev),
            _lib.check(tau, "tau", (n,), dev),
            _lib.check(blevel, "blevel", (n,), dev),
            _lib.check(begins, "begins", (n, k), dev),
            _lib.check(ends, "ends", (n, k), dev),
            _lib.check(exact, "exact", (n, k), dev),
            _lib.check(s_plus, "s_plus", (n, w), dev),
            _lib.check(s_minus, "s_minus", (n, w), dev),
            _lib.check(cs, "cs", (q,), dev),
            _lib.check(ct, "ct", (q,), dev))
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        _lib.launch("stab_naive", "reach_stab_naive", dev, *args,
                    out.data_ptr(), q, k, w)
    return out
