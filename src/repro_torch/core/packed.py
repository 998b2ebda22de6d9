"""PackedIndex — device-friendly layout of a FerrariIndex.

Fixed-width slab layout for the Pallas ``interval_stab`` kernel:
  begins/ends  [n, k_max] int32 (invalid slots: begin = INT32_MAX, end = -1)
  exact        [n, k_max] bool packed as int32 0/1
  pi, tau, blevel [n] int32
  s_plus/s_minus  [n, words] uint32
plus CSR adjacency of the condensed DAG and the original→condensed comp map.

Slabs (not CSR ragged) because k_max ≤ c·k is tiny (≤ 8-32): a fixed-width
masked compare is branch-free and fully lane-parallel on the VPU — see
DESIGN.md §3. The memory overhead vs CSR is bounded by k_max/avg_intervals
(≈2-3× typical) and is the price of O(1) addressing; measured in benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .ferrari import FerrariIndex

INVALID_BEGIN = np.int32(2**31 - 1)


@dataclass
class PackedIndex:
    n: int                    # condensed node count (root EXCLUDED)
    k_max: int
    begins: np.ndarray        # [n, k_max] int32
    ends: np.ndarray          # [n, k_max] int32
    exact: np.ndarray         # [n, k_max] int32 (0/1)
    pi: np.ndarray            # [n] int32
    tau: np.ndarray           # [n] int32
    blevel: np.ndarray        # [n] int32
    s_plus: Optional[np.ndarray]   # [n, w] uint32 (None if seeds disabled)
    s_minus: Optional[np.ndarray]
    adj_indptr: np.ndarray    # [n+1] int32  condensed DAG adjacency
    adj_indices: np.ndarray   # [m] int32
    comp: np.ndarray          # [n_orig] int32 original node -> condensed id
    max_out_degree: int

    def byte_size(self) -> int:
        tot = (self.begins.nbytes + self.ends.nbytes + self.exact.nbytes +
               self.pi.nbytes + self.tau.nbytes + self.blevel.nbytes +
               self.adj_indptr.nbytes + self.adj_indices.nbytes)
        if self.s_plus is not None:
            tot += self.s_plus.nbytes + self.s_minus.nbytes
        return tot

    def fused_layout(self):
        """Gather-fused serving layout (§Perf iterations F1 + F4).

        The naive device layout needs 12 gathers per query (~176 B incl.
        index reads). Fused:
          slab [n, 2K] int32 — begins (exact flag in the SIGN bit; π < 2³¹
                               so it is free) followed by ends: ONE gather.
          meta [n, 4] int32 — word0 = π | min(blevel, 255) << 24 (π < 2²⁴
                              at web scale; levels saturate SOUNDLY — the
                              ≤-filter is suppressed when the source level
                              is saturated, see kernels/ref.py), word1 = τ,
                              word2 = s⁺, word3 = s⁻ (single-word seeds).
        ≈ 96 B/query, 3 gather ops, and a 16 B/row exchange unit for the
        sharded placement. Returns (slab, meta), or (None, None) when the
        seed sets are multi-word or π needs more than 24 bits.
        """
        w = 0 if self.s_plus is None else self.s_plus.shape[1]
        if w > 1 or self.n > (1 << 24):
            return None, None
        flag = (self.exact.astype(np.uint32) << np.uint32(31))
        begins_f = (self.begins.view(np.uint32) | flag).view(np.int32)
        slab = np.concatenate([begins_f, self.ends], axis=1)
        if w == 1:
            sp = self.s_plus[:, 0].view(np.int32)
            sm = self.s_minus[:, 0].view(np.int32)
        else:
            sp = np.zeros(self.n, np.int32)
            sm = sp
        lvl8 = np.minimum(self.blevel, 255).astype(np.uint32)
        word0 = (self.pi.view(np.uint32) | (lvl8 << np.uint32(24))
                 ).view(np.int32)
        meta = np.stack([word0, self.tau, sp, sm], axis=1)
        return np.ascontiguousarray(slab), np.ascontiguousarray(meta)

    def ell_layout(self, width: Optional[int] = None, width_cap: int = 32):
        """Fixed-width ELL adjacency for the sparse phase-2 frontier engine
        (kernels/frontier.py), with a COO tail for heavy out-degrees.

        Returns (ell, tail_src, tail_dst):
          ell      [n, W] int32 — first W out-neighbors of each node, -1 pad.
                   One contiguous gather row per frontier node: the device
                   BFS expands a compacted frontier with ``ell[front]``.
          tail_*   [m_t] int32 — COO edges of nodes whose out-degree exceeds
                   W (the heavy tail a fixed-width slab cannot hold). These
                   are swept edge-parallel per step, so correctness never
                   depends on W; W only trades slab padding vs tail size.

        W defaults to min(max_out_degree, width_cap): scale-free graphs have
        a tiny number of hub rows, and capping W keeps the slab at n·W·4 B
        instead of n·max_deg·4 B.
        """
        deg = np.diff(self.adj_indptr).astype(np.int64)
        if width is None:
            width = int(min(max(1, self.max_out_degree), width_cap))
        m = int(self.adj_indices.size)
        src = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        rank = np.arange(m, dtype=np.int64) - np.repeat(
            self.adj_indptr[:-1].astype(np.int64), deg)
        in_ell = rank < width
        ell = np.full((self.n, width), -1, dtype=np.int32)
        ell[src[in_ell], rank[in_ell]] = self.adj_indices[in_ell]
        tail_src = src[~in_ell].astype(np.int32)
        tail_dst = self.adj_indices[~in_ell].astype(np.int32)
        return ell, tail_src, tail_dst

    def to_torch(self, device, fused: bool = True) -> dict:
        """Return a dict of int32 tensors on ``device``.

        Keys follow the reference ``to_device``: the 12-array layout
        (``begins``/``ends``/``exact``/``pi``/``tau``/``blevel``, seeds as
        ``s_plus``/``s_minus``), the condensed adjacency, ``comp``, and the
        fused ``slab [n, 2K]`` / ``meta [n, 4]`` when ``fused_layout``
        admits this index. The uint32 seed words travel as int32 views:
        ``&``, ``|``, ``~`` and ``!= 0`` give the same bits either way.
        """
        import torch
        arrs = {
            "begins": self.begins, "ends": self.ends, "exact": self.exact,
            "pi": self.pi, "tau": self.tau, "blevel": self.blevel,
            "adj_indptr": self.adj_indptr, "adj_indices": self.adj_indices,
            "comp": self.comp,
        }
        if self.s_plus is not None:
            arrs["s_plus"] = self.s_plus.view(np.int32)
            arrs["s_minus"] = self.s_minus.view(np.int32)
        if fused:
            slab, meta = self.fused_layout()
            if slab is not None:
                arrs["slab"] = slab
                arrs["meta"] = meta
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)
                                    ).to(device)
                for k, v in arrs.items()}


def pack_index(ix: FerrariIndex, k_max: Optional[int] = None) -> PackedIndex:
    n = ix.tl.n  # condensed nodes, root excluded from the packed table
    sizes = np.array([ix.labels[v][0].size for v in range(n)], dtype=np.int64)
    if k_max is None:
        k_max = int(sizes.max(initial=1))
    if int(sizes.max(initial=0)) > k_max:
        raise ValueError(f"label wider than k_max: {sizes.max()} > {k_max}")
    begins = np.full((n, k_max), INVALID_BEGIN, dtype=np.int32)
    ends = np.full((n, k_max), -1, dtype=np.int32)
    exact = np.zeros((n, k_max), dtype=np.int32)
    for v in range(n):
        b, e, x = ix.labels[v]
        c = b.size
        begins[v, :c] = b
        ends[v, :c] = e
        exact[v, :c] = x
    dag = ix.cond.dag
    return PackedIndex(
        n=n, k_max=k_max, begins=begins, ends=ends, exact=exact,
        pi=ix.tl.pi[:n].astype(np.int32),
        tau=ix.tl.tau[:n].astype(np.int32),
        blevel=ix.tl.blevel[:n].astype(np.int32),
        s_plus=(None if ix.seeds is None else ix.seeds.s_plus),
        s_minus=(None if ix.seeds is None else ix.seeds.s_minus),
        adj_indptr=dag.indptr.astype(np.int32),
        adj_indices=dag.indices.astype(np.int32),
        comp=ix.cond.comp.astype(np.int32),
        max_out_degree=int(dag.degrees().max(initial=0)),
    )
