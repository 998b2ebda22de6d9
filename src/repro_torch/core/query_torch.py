"""Batched device query engine — the production serving path, on PyTorch.

Two phases, with the answers and phase mix of the reference engine
(``repro.core.query_jax``):

  Phase 1  (``kernels.ops.classify_queries``): one kernel launch classifies
  every query as POS / NEG / UNKNOWN from the source's interval slab and
  the paper's §5 filters.

  Phase 2  runs the UNKNOWN residue, selected by ``phase2_mode``:

    dense   [Q, n] frontier rows stepped with ``frontier @ A`` — for
            n ≤ n_dense_max (default 8192); the [Q·n] node-vs-target
            verdicts come from the phase-1 kernel.
    sparse  the fused-step frontier BFS over the ELL slab + COO tail
            (``kernels.frontier_fused``). A frontier that outgrows its
            capacity sets an overflow flag; the driver retries unresolved
            queries with 4× capacity (positives found under overflow are
            already sound) and falls back to the host engine only past
            ``frontier_cap_max``.
    host    per-query guided DFS on ``core.query.QueryEngine``.

  ``phase2_mode="auto"`` picks dense for n ≤ n_dense_max and sparse above.

The engine lives on one ``device``: "cuda" (the default) runs the
hand-written kernels; "cpu" runs their plain PyTorch versions and must be
asked for explicitly. Without a CUDA device, the default raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels import frontier, ops
from .ferrari import FerrariIndex
from .packed import PackedIndex, pack_index
from .query import QueryEngine, ResettableStats


@dataclass
class ServeStats(ResettableStats):
    n_queries: int = 0
    phase1_pos: int = 0
    phase1_neg: int = 0
    phase2_queries: int = 0
    phase2_dense: int = 0
    phase2_sparse: int = 0
    phase2_host: int = 0
    sparse_retries: int = 0


def resolve_device(device) -> torch.device:
    """The engine's device: a CUDA device must exist; the CPU (plain
    versions of the kernels) is taken only when asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port serves on the GPU; pass "
                "device='cpu' to run the kernels' plain versions instead")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _dense_bfs(front0, expandable, definite_pos, adj, max_steps: int):
    """Batched masked BFS. front0/expandable/definite_pos: [Q, n] bool;
    adj: [n, n] f32 (adj[u, w] = 1 iff edge u->w). Returns pos [Q] bool.
    One host sync per step for the stop test."""
    pos = (front0 & definite_pos).any(dim=1)
    front = front0 & expandable & ~pos[:, None]
    visited = front.clone()          # the masked front0, as the reference
    step = 0
    while step < max_steps and bool(front.any()):
        reached = (front.to(torch.float32) @ adj) > 0.5
        new = reached & ~visited
        pos |= (new & definite_pos).any(dim=1)
        visited |= new
        front = new & expandable & ~pos[:, None]
        step += 1
    return pos


class DeviceQueryEngine:
    """answer(srcs, dsts) with the semantics of core.query.QueryEngine.

    Prefer constructing through ``repro_torch.reach`` (``IndexSpec`` +
    ``QuerySession``): it owns bucketed batching and statistics. ``packed``
    / ``ell`` inject pre-built layouts so construction skips the O(n) host
    packing loops.
    """

    def __init__(self, index: FerrariIndex, n_dense_max: int = 8192,
                 phase2_chunk: int = 256, phase2_mode: str = "auto",
                 ell_width: Optional[int] = None, frontier_cap: int = 4096,
                 frontier_cap_max: int = 1 << 18,
                 packed: Optional[PackedIndex] = None, ell=None,
                 device="cuda"):
        if phase2_mode not in ("auto", "dense", "sparse", "host"):
            raise ValueError(f"unknown phase2_mode {phase2_mode!r}")
        self.device = resolve_device(device)
        self.index = index
        self.packed: PackedIndex = pack_index(index) if packed is None else packed
        self.dev = self.packed.to_torch(self.device)
        self.comp = self.dev["comp"]
        self.phase2_chunk = phase2_chunk
        self.ell_width = ell_width
        self.frontier_cap = frontier_cap
        self.frontier_cap_max = frontier_cap_max
        self.stats = ServeStats()
        # wall-clock of the LAST finish_answer's two phases
        self.last_phase1_s = 0.0
        self.last_phase2_s = 0.0
        self._batch_shapes = set()    # distinct phase-1 batch sizes seen
        n = self.packed.n
        # from the UNSATURATED levels: the meta word's 8-bit copy caps at 255
        self.max_steps = int(index.tl.blevel[:n].max(initial=0)) + 1
        if phase2_mode == "auto":
            phase2_mode = "dense" if n <= n_dense_max else "sparse"
        self.phase2_mode = phase2_mode
        self.adj_dense = None
        if phase2_mode == "dense":
            a = torch.zeros((n, n), dtype=torch.float32)
            src, dst = index.cond.dag.edges()
            a[torch.from_numpy(np.asarray(src, np.int64)),
              torch.from_numpy(np.asarray(dst, np.int64))] = 1.0
            self.adj_dense = a.to(self.device)
        self._ell_host = ell          # optional injected (ell, tsrc, tdst)
        self._ell_dev = None          # built lazily on first sparse use
        self._host_engine = None      # built lazily on first host use

    # ------------------------------------------------------ lazy structures
    @property
    def _host(self) -> QueryEngine:
        if self._host_engine is None:
            self._host_engine = QueryEngine(self.index)
        return self._host_engine

    def _ell(self):
        if self._ell_dev is None:
            if self._ell_host is not None:
                ell, tsrc, tdst = self._ell_host
            else:
                ell, tsrc, tdst = self.packed.ell_layout(width=self.ell_width)
            is_hub = np.zeros(self.packed.n, dtype=bool)
            is_hub[tsrc] = True
            self._ell_dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (ell.astype(np.int32), tsrc.astype(np.int32),
                          tdst.astype(np.int32), is_hub))
        return self._ell_dev

    def _tensor(self, a, dtype=torch.int32):
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device).to(dtype)

    # --------------------------------------------------------------- phase 1
    @property
    def trace_count(self) -> int:
        """Distinct phase-1 batch shapes so far (the reference counts jit
        traces, one per shape; the session keeps this at one per bucket)."""
        return len(self._batch_shapes)

    def classify(self, srcs, dsts):
        cs = self.comp[self._tensor(srcs, torch.int64)]
        ct = self.comp[self._tensor(dsts, torch.int64)]
        self._batch_shapes.add(int(cs.shape[0]))
        return ops.classify_queries(self.dev, cs, ct), cs, ct

    def stage_queries(self, srcs, dsts):
        """Start the host→device transfer of a query batch and return
        tensors ``classify`` accepts: int64 ids copied from pinned host
        buffers with ``non_blocking`` on the current stream."""
        out = []
        for a in (srcs, dsts):
            t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out)

    # ------------------------------------------------------------------ API
    def answer(self, srcs, dsts) -> np.ndarray:
        return self.finish_answer(self.start_answer(srcs, dsts))

    def start_answer(self, srcs, dsts):
        """Launch phase 1 without waiting for its result: the caller may
        overlap host work (staging the next batch) before
        ``finish_answer``."""
        return self.classify(srcs, dsts)

    def finish_answer(self, handle) -> np.ndarray:
        """Wait for a ``start_answer`` handle and run phase 2 on the
        UNKNOWN residue. ``answer()`` is exactly start + finish; the two
        phases' wall-clock lands in ``last_phase1_s``/``last_phase2_s``."""
        verdict, cs, ct = handle
        t0 = time.perf_counter()
        verdict = verdict.cpu().numpy()
        out = verdict == ops.POS
        unknown = np.flatnonzero(verdict == ops.UNKNOWN)
        self.stats.n_queries += len(verdict)
        self.stats.phase1_pos += int(out.sum())
        self.stats.phase1_neg += int((verdict == ops.NEG).sum())
        self.stats.phase2_queries += unknown.size
        t1 = time.perf_counter()
        self.last_phase1_s = t1 - t0
        self.last_phase2_s = 0.0
        if unknown.size == 0:
            return out
        cs_u = cs.cpu().numpy()[unknown]
        ct_u = ct.cpu().numpy()[unknown]
        if self.phase2_mode == "dense":
            self.stats.phase2_dense += unknown.size
            res = self._phase2_dense(cs_u, ct_u)
        elif self.phase2_mode == "sparse":
            res = self._phase2_sparse(cs_u, ct_u)
        else:
            self.stats.phase2_host += unknown.size
            res = self._phase2_host(cs_u, ct_u)
        out[unknown] = res
        self.last_phase2_s = time.perf_counter() - t1
        return out

    # --------------------------------------------------------------- phase 2
    def _phase2_host(self, cs_u: np.ndarray, ct_u: np.ndarray) -> np.ndarray:
        return np.fromiter(
            (self._host._reachable_condensed(int(a), int(b))
             for a, b in zip(cs_u, ct_u)), dtype=bool, count=cs_u.size)

    def _phase2_dense(self, cs_u: np.ndarray, ct_u: np.ndarray) -> np.ndarray:
        n = self.packed.n
        chunk = self.phase2_chunk
        res = np.zeros(cs_u.size, dtype=bool)
        for lo in range(0, cs_u.size, chunk):
            hi = min(lo + chunk, cs_u.size)
            q = hi - lo
            # fixed chunk shape, padded with (0, 0) self-queries, which
            # resolve at step 0 — as the reference, which must not retrace
            cs_h = np.zeros(chunk, dtype=np.int32)
            ct_h = np.zeros(chunk, dtype=np.int32)
            cs_h[:q] = cs_u[lo:hi]
            ct_h[:q] = ct_u[lo:hi]
            cs, ct = self._tensor(cs_h), self._tensor(ct_h)
            expandable, definite_pos = ops.classify_all_nodes_vs_target(
                self.dev, ct)
            front0 = torch.nn.functional.one_hot(cs.long(), n).bool()
            pos = _dense_bfs(front0, expandable, definite_pos,
                             self.adj_dense, self.max_steps)
            res[lo:hi] = pos.cpu().numpy()[:q]
        return res

    def _phase2_chunk_size(self) -> int:
        """Queries per sparse expansion call (key packing bounds it)."""
        return min(self.phase2_chunk, frontier.max_batch(self.packed.n))

    def _expand_chunk(self, cs_t, ct_t, pad: np.ndarray, cap: int):
        """One frontier expansion: (pos [chunk] np.bool_, overflow bool)."""
        ell, tsrc, tdst, is_hub = self._ell()
        p, ovf = ops.expand_frontier(
            self.dev, ell, tsrc, tdst, is_hub, cs_t, ct_t,
            torch.from_numpy(pad).to(self.device),
            max_steps=self.max_steps, cap=cap)
        return p.cpu().numpy(), ovf

    def _phase2_sparse(self, cs_u: np.ndarray, ct_u: np.ndarray) -> np.ndarray:
        """Chunked expansion with the overflow-retry / terminal-host-
        fallback policy of the reference ``_sparse_driver``."""
        chunk = self._phase2_chunk_size()
        res = np.zeros(cs_u.size, dtype=bool)
        self.stats.phase2_sparse += cs_u.size
        for lo in range(0, cs_u.size, chunk):
            hi = min(lo + chunk, cs_u.size)
            q = hi - lo
            cs = np.zeros(chunk, np.int32)
            ct = np.zeros(chunk, np.int32)
            cs[:q] = cs_u[lo:hi]
            ct[:q] = ct_u[lo:hi]
            pad = np.ones(chunk, bool)
            pad[:q] = False
            cs_t, ct_t = self._tensor(cs), self._tensor(ct)
            cap = max(self.frontier_cap, chunk)
            pos = np.zeros(chunk, bool)
            while True:
                p, ovf = self._expand_chunk(cs_t, ct_t, pad, cap)
                pos |= p
                if not ovf:
                    break
                # overflow: POS answers are sound, only non-positives need
                # the retry — mask them out and rerun with 4x the capacity
                cap *= 4
                self.stats.sparse_retries += 1
                if cap > self.frontier_cap_max:
                    unresolved = np.flatnonzero(~pos & ~pad)
                    self.stats.phase2_host += unresolved.size
                    self.stats.phase2_sparse -= unresolved.size
                    pos[unresolved] = self._phase2_host(cs[unresolved],
                                                        ct[unresolved])
                    break
                pad = pad | pos
                if pad.all():
                    break       # every live query already proved positive
            res[lo:hi] = pos[:q]
        return res
