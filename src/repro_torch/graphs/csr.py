"""Compressed-sparse-row graph representation (host-side substrate).

All core algorithms operate on this: a directed graph is (n, CSR out-adj),
with the reverse CSR derived on demand. Edge arrays are int32 (node ids fit
easily; the paper's largest condensed graph has 22.7M nodes).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSR:
    n: int
    indptr: np.ndarray   # [n+1] int64
    indices: np.ndarray  # [m]  int32, neighbor ids, sorted within each row

    @property
    def m(self) -> int:
        return int(self.indices.size)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def edges(self):
        """Return (src, dst) edge arrays."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        return src, self.indices.copy()


def build_csr(n: int, src, dst, dedup: bool = True) -> CSR:
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size:
        assert src.min() >= 0 and src.max() < n, "src out of range"
        assert dst.min() >= 0 and dst.max() < n, "dst out of range"
    if dedup and src.size:
        # sorted unique keys by a sort: np.unique may hash instead (numpy
        # 2.3), far slower on tens of millions of edges
        key = np.sort(src * np.int64(n) + dst)
        key = key[np.r_[True, key[1:] != key[:-1]]]
        src = key // n
        dst = key % n
    else:
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(n=n, indptr=indptr, indices=dst.astype(np.int32))


def reverse_csr(g: CSR) -> CSR:
    src, dst = g.edges()
    return build_csr(g.n, dst, src, dedup=False)


def concat_rows(indptr: np.ndarray, indices: np.ndarray,
                nodes: np.ndarray) -> np.ndarray:
    """The CSR rows of ``nodes``, concatenated in order: one vectorized
    gather for ``np.concatenate([indices[indptr[v]:indptr[v + 1]] for v
    in nodes])``."""
    nodes = np.asarray(nodes, dtype=np.int64)
    starts = indptr[nodes]
    lens = indptr[nodes + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=indices.dtype)
    first = np.cumsum(lens) - lens          # each row's place in the output
    return indices[np.repeat(starts - first, lens) + np.arange(total)]


def remove_self_loops(n: int, src, dst):
    src = np.asarray(src)
    dst = np.asarray(dst)
    keep = src != dst
    return src[keep], dst[keep]


def in_degrees(g: CSR) -> np.ndarray:
    d = np.zeros(g.n, dtype=np.int64)
    np.add.at(d, g.indices, 1)
    return d
