"""Replicated and sharded serving of the FERRARI index on torch.distributed.

Two index placements, both driving the full two-phase query pipeline, one
process a device (``torchrun``, or ranks the caller starts):

  * ``replicated`` — every rank holds the whole packed index; queries shard
    over the ``data`` ranks, each classifies and expands its block with the
    one-device kernels reading the tables in place (kernel 1, and kernels 3
    and 4 as one CUDA graph a call); one ``all_gather`` a call returns the
    whole answer. No exchange of table rows.
  * ``sharded``    — the table rows shard over the ``model`` ranks (an index
    larger than one card's memory). Phase 1 (``classify_sharded``) is
    compute-at-owner: t's meta rows are summed over the model group from
    the ranks that own them (16 B a query), the rank that owns a query's
    source row computes its whole verdict there (kernel 1's owned-rows
    entry) and one masked int32 sum over the model group reassembles it
    (4 B a query). Phase 2 (``expand_frontier_sharded``) runs the sparse
    frontier loop on each data rank's block of the UNKNOWN residue with
    every index touch exchanged the same way: the front's ELL rows (kernel
    3's exchanged-rows entry reads them), then each survivor's verdict
    (kernel 1's owned-rows entry, then kernel 4 as mark and emit). A rank
    cannot read a sharded slab in place, so this loop steps from the host.

The mesh (``ServingMesh``) is the process group laid out (data, model):
world D·M, rank r = d·M + m, one model group a data row, one data group a
model column. BFS state is the same on every rank of a model group, so its
loop stays in lockstep for the group's collectives, while data rows run
their own trip counts; the overflow flag is agreed over the world before
the driver decides to retry (``DistributedQueryEngine._agree``), so every
rank retries the same chunk. Every rank calls ``QuerySession.query`` with
the same batch and gets back the whole answer; answers and statistics are
the same on every rank.

``DistributedQueryEngine`` keeps the ``DeviceQueryEngine`` interface, so
``reach.QuerySession`` serves multi-device without changes — select it with
``IndexSpec(placement="replicated"|"sharded", mesh="DATAxMODEL")``. The
caller initialises the process group (``torch.distributed.
init_process_group``: NCCL between cards, gloo on the CPU or for ranks that
share a card); the engine picks no backend. The reference drives one JAX
mesh from one process with ``shard_map`` and ``psum``; the answers, the
verdicts and the phase mix are the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import frontier_fused, ops
from ..kernels.frontier_fused import emit_plain
from ..launch.mesh import Mesh
from ..parallel.collectives import all_gather_, all_reduce_
from .query_torch import DeviceQueryEngine, StagedIds

PLACEMENTS = ("replicated", "sharded")


class ServingMesh(Mesh):
    """The (data, model) serving mesh, the (data, model) case of
    ``launch.mesh.Mesh`` over the initialised process group: ``shape``
    (D, M) with D·M = world, this rank at (``d``, ``m``) = divmod (rank,
    M), its model group (the M ranks of its data row) and data group
    (the D ranks of its model column), and its ``device``
    (``query_torch.resolve_device``: "cuda" names the current card, which
    the caller sets to the rank's, ``torch.cuda.set_device``).

    Defaults as the reference's ``make_serving_mesh``: replicated puts
    every rank on the data axis, sharded every rank on the model axis.
    Raises ``RuntimeError`` when no process group is initialised and
    ``ValueError`` when D·M is not the world size or a replicated mesh has
    M > 1. Groups of one rank are not created: a collective over them is
    the identity."""

    def __init__(self, placement: str, shape: Optional[Tuple[int, int]] = None,
                 device="cuda"):
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {placement!r}")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"placement={placement!r} serves over torch.distributed: "
                "initialise the process group first (torchrun, or "
                "init_process_group with this rank's world and rank)")
        world = dist.get_world_size()
        if shape is None:
            shape = (world, 1) if placement == "replicated" else (1, world)
        d, m = (int(x) for x in shape)
        if d < 1 or m < 1 or d * m != world:
            raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, the "
                             f"process group has {world}")
        if placement == "replicated" and m != 1:
            raise ValueError("replicated placement holds whole tables per "
                             "device: the model axis must be 1")
        super().__init__((d, m), ("data", "model"), device=device)
        self.placement = placement

    def __repr__(self) -> str:
        return (f"ServingMesh({self.placement}, {self.n_data}x{self.n_model}"
                f", rank {self.rank} at ({self.d}, {self.m}), {self.device})")

    # --------------------------------------------------------- collectives
    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the model group (a new tensor)."""
        if self.model_group is None:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.model_group)
        return out

    def gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """The data ranks' blocks of ``t``, concatenated in rank order."""
        if self.data_group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n_data)]
        dist.all_gather(parts, t, group=self.data_group)
        return torch.cat(parts)

    def agree(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any rank."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This data rank's contiguous block of ``t`` ([Q], Q a multiple of
        D)."""
        b = t.shape[0] // self.n_data
        return t[self.d * b:(self.d + 1) * b]


# ------------------------------------------------------------ table rows
def _take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` of an [n, W] int32 table and int64 ids. A row of
    four int32 (meta) moves as one 16-byte element (a complex128 view of
    the same bytes), wider rows through ``torch.take`` on flat offsets:
    PyTorch's gather of the rows of a 2-D table took 10.1 ms for 2^24
    meta rows on an H100, the 16-byte elements 0.63 ms."""
    n, w = table.shape
    if w == 4 and table.is_contiguous():
        flat = table.view(torch.float64).view(torch.complex128).view(n)
        return flat[ids].view(torch.float64).view(torch.int32).view(-1, 4)
    off = ids[:, None] * w + torch.arange(w, device=ids.device)
    return torch.take(table, off)


def _own_rows(table: torch.Tensor, ids: torch.Tensor, base: int):
    """The rows of global ids ``ids`` [Q] that this shard of ``table``
    ([n_loc, W], rows ``base`` .. ``base + n_loc``) owns; zero rows for the
    others, so a sum over the model group gives every row once."""
    n_loc = table.shape[0]
    rel = ids.long() - base
    own = (rel >= 0) & (rel < n_loc)
    rows = _take_rows(table, rel.clamp(0, n_loc - 1))
    return rows.masked_fill_(~own[:, None], 0)


def _pad_rows(a: np.ndarray, n_pad: int, fill=0) -> np.ndarray:
    """Pad dim 0 to ``n_pad`` rows of ``fill`` (so the model axis divides
    evenly). Padded rows are never read: queries and ELL entries name only
    real ids."""
    if a.shape[0] == n_pad:
        return a
    out = np.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def shard_rows(a: np.ndarray, mesh: ServingMesh, fill=0) -> np.ndarray:
    """This rank's rows of ``a`` [n, ...]: n padded with ``fill`` to
    n_pad = ceil(n / M)·M, then block m of n_pad / M rows."""
    m = mesh.n_model
    n_loc = -(-a.shape[0] // m)
    lo = mesh.m * n_loc
    return _pad_rows(np.ascontiguousarray(a[lo:lo + n_loc]), n_loc, fill)


def shard_tables(slab: np.ndarray, meta: np.ndarray,
                 mesh: ServingMesh) -> dict:
    """The fused tables' shard of this rank, on its device: {"slab":
    [n_pad / M, 2K], "meta": [n_pad / M, 4]} int32."""
    return {name: torch.from_numpy(shard_rows(a, mesh)).to(mesh.device)
            for name, a in (("slab", slab), ("meta", meta))}


def _pad_to(t: torch.Tensor, size: int) -> torch.Tensor:
    """``t`` [Q] padded with zeros to ``size``."""
    if t.shape[0] == size:
        return t
    out = torch.zeros(size, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


# --------------------------------------------------------------- phase 1
def _model_sum(mesh: Mesh, t: torch.Tensor, name: str) -> torch.Tensor:
    """Sum of ``t`` over the model group (a new tensor; ``t`` itself where
    the group is one rank), counted in ``parallel.CALLS`` under
    ``name``."""
    if mesh.model_group is None:
        return t
    return all_reduce_(t.contiguous().clone(), mesh.model_group, name)


def _owner_verdict(mesh: Mesh, state: dict, cs, ct):
    """Compute-at-owner: t's meta rows summed over the model group from
    the ranks that own them, the owner of each source row computes the
    whole verdict there (kernel 1's owned-rows entry, 0 elsewhere), and
    one int32 sum over the group reassembles it."""
    meta = state["meta"]
    base = mesh.m * meta.shape[0]
    meta_t = _model_sum(mesh, _own_rows(meta, ct, base), "owner_rows")
    return _model_sum(mesh, ops.classify_queries(
        {"_prefetched": True, "meta_t": meta_t, "meta": meta,
         "slab": state["slab"], "base": base}, cs, ct), "owner_verdict")


def _over_data(mesh: Mesh, cs, ct, classify):
    """``classify(cs, ct)`` of this rank's block of the batch over the
    data axes ('pod', 'data'), the blocks gathered: the whole verdict on
    every rank. (0, 0) self-queries pad the batch to a multiple of the
    data ranks (POS, stripped)."""
    axes = mesh.dp_axes
    n, q = mesh.size(axes), cs.shape[0]
    q_pad = -(-q // n) * n
    b = q_pad // n
    lo = mesh.index(axes) * b if n > 1 else 0
    v = classify(_pad_to(cs, q_pad)[lo:lo + b], _pad_to(ct, q_pad)[lo:lo + b])
    if n == 1:
        return v[:q]
    return all_gather_(v, mesh.group(axes), 0, mesh.members(axes),
                       "verdicts")[:q]


def classify_sharded(mesh: Mesh, state: dict, cs, ct):
    """Phase-1 verdict [Q] int32 with the table rows sharded over the
    model ranks and the queries over the data ranks ('pod' and 'data';
    ``mesh`` a ``ServingMesh`` or any ``launch.mesh.Mesh`` with a model
    axis). ``state``: this
    rank's shard {"slab": [n_loc, 2K], "meta": [n_loc, 4]} (rows from
    m·n_loc); ``cs``, ``ct`` [Q] int32: the whole batch, the same on every
    rank. Returns the whole verdict on every rank."""
    return _over_data(mesh, cs, ct,
                      lambda a, b: _owner_verdict(mesh, state, a, b))


# --------------------------------------------------------------- phase 2
def expand_frontier_sharded(mesh: ServingMesh, state: dict, ell, tail_src,
                            tail_dst, is_hub, cs, ct, pad, *, n_nodes: int,
                            max_steps: int, cap: int, can_reach_tail=None,
                            workspaces=None):
    """Sparse phase-2 expansion of one chunk under either placement.

    ``cs``, ``ct``, ``pad`` [Q] (Q a multiple of D, the same on every rank):
    each data rank expands its block. ``state`` / ``ell``: the rank's rows
    of the fused tables and of the ELL slab (all of them when replicated;
    n_pad / M from m·n_pad / M on when sharded); ``n_nodes``: n_pad, the
    node ids' range; ``tail_src``, ``tail_dst``, ``is_hub`` [n_pad] and
    ``can_reach_tail`` (a live overlay's, [n]) are whole on every rank.
    Replicated: the one-device loop on the block (one CUDA graph a call
    on a card).
    Sharded: the loop steps from the host, the front's ELL rows and each
    survivor's verdict exchanged over the model group (kernel 3's
    exchanged-rows entry, kernel 1's owned-rows entry, kernel 4 as mark
    and emit with the overlay rule on the exchanged verdicts).

    Returns (pos [Q] bool on the host, the whole chunk on every rank;
    overflow, this data rank's flag: the caller agrees it over the
    world)."""
    cs_b, ct_b, pad_b = mesh.block(cs), mesh.block(ct), mesh.block(pad)
    if mesh.placement == "replicated":
        p, ovf = ops.expand_frontier(
            state, ell, tail_src, tail_dst, is_hub, cs_b, ct_b, pad_b,
            max_steps=max_steps, cap=cap, workspaces=workspaces,
            can_reach_tail=can_reach_tail)
    else:
        base = mesh.m * ell.shape[0]

        def gather(table, ids):
            return mesh.model_sum(_own_rows(table, ids, base))

        def classify(cands, tgts, keys, eq):
            # eq: the owned entry folds cands == tgts to POS itself
            return emit_plain(_owner_verdict(mesh, state, cands, tgts), keys)

        p, ovf = frontier_fused.expand_frontier_loop_fused(
            ell, tail_src, tail_dst, is_hub, cs_b, ct_b, pad_b,
            n_nodes=n_nodes, max_steps=max_steps, cap=cap,
            gather_rows=gather, classify=classify,
            can_reach_tail=can_reach_tail, workspaces=workspaces)
    # int32 over the wire: a backend need not carry bool
    pos = mesh.gather_data(p.to(mesh.device, torch.int32)).cpu() != 0
    return pos, ovf


# ---------------------------------------------------------------- engine
class DistributedQueryEngine(DeviceQueryEngine):
    """Multi-device two-phase engine: the answers and interface of
    ``DeviceQueryEngine``, phase 1 and the sparse phase 2 over a
    ``ServingMesh`` (``classify_sharded`` / ``expand_frontier_sharded``).

    Every rank calls ``answer`` with the same batch: ids stay on the host
    (``stage_queries``), each data rank classifies its block, and the
    verdicts are gathered, so the residue, the chunks, the overflow retries
    (flag agreed over the world) and the terminal host fallback are the
    same on every rank. ``phase2_mode`` "auto" means sparse; "dense" (an
    n×n adjacency on one card) raises ``ValueError``. Both placements need
    the gather-fused layout (one seed word, n ≤ 2^24). The ``mesh``'s
    placement is the engine's, its device the engine's device (a
    compaction's new engine keeps its session's mesh).
    """

    def __init__(self, index, mesh: ServingMesh, *, n_dense_max: int = 8192,
                 phase2_chunk: int = 256, phase2_mode: str = "auto",
                 ell_width: Optional[int] = None, frontier_cap: int = 4096,
                 frontier_cap_max: int = 1 << 18, packed=None, ell=None,
                 overlay_cap: int = 4096):
        if phase2_mode == "auto":
            phase2_mode = "sparse"     # dense needs the n×n adjacency on
        if phase2_mode == "dense":     # one card: what sharding avoids
            raise ValueError(
                "phase2_mode='dense' is single-device only; "
                "use 'sparse' (or 'host') under a distributed placement")
        self.mesh = mesh
        self.placement = mesh.placement
        self.n_dp = mesh.n_data
        self._ell_dist = None
        super().__init__(index, n_dense_max=n_dense_max,
                         phase2_chunk=phase2_chunk, phase2_mode=phase2_mode,
                         ell_width=ell_width, frontier_cap=frontier_cap,
                         frontier_cap_max=frontier_cap_max, packed=packed,
                         ell=ell, overlay_cap=overlay_cap, device=mesh.device)
        self._comp_np = self.packed.comp

    def _device_tables(self) -> dict:
        """The rank's fused tables: all rows when replicated, its shard of
        n_pad / M rows when sharded."""
        slab, meta = self.packed.fused_layout()
        if slab is None:
            raise ValueError(
                "distributed serving requires the gather-fused layout "
                "(single-word seed sets, n <= 2^24) — see PackedIndex."
                "fused_layout")
        m = self.mesh.n_model
        self.n_pad = -(-self.packed.n // m) * m
        return shard_tables(slab, meta, self.mesh)

    # --------------------------------------------------------------- phase 1
    def _ids_to_device(self, srcs, dsts) -> StagedIds:
        # the sharded classify pads to the data split and places each rank's
        # block itself: staging keeps the batch on the host
        return StagedIds(torch.stack([
            torch.as_tensor(np.asarray(a), dtype=torch.int64)
            for a in (srcs, dsts)]))

    def classify(self, srcs, dsts):
        """Phase 1 of original-id batches on every rank: (verdict, cs, ct)
        on the rank's device, the whole batch."""
        cs = torch.from_numpy(self._comp_np[np.asarray(srcs)].astype(
            np.int32)).to(self.device)
        ct = torch.from_numpy(self._comp_np[np.asarray(dsts)].astype(
            np.int32)).to(self.device)
        self._batch_shapes.add(int(cs.shape[0]))
        if self.placement == "sharded":
            return classify_sharded(self.mesh, self.dev, cs, ct), cs, ct
        return _over_data(self.mesh, cs, ct, lambda a, b: ops.classify_queries(
            self.dev, a, b)), cs, ct

    def start_answer(self, staged: StagedIds):
        ids = staged.ids.numpy()
        return (*self.classify(ids[0], ids[1]), staged)

    # --------------------------------------------------------------- phase 2
    def _ell(self):
        """The rank's rows of the ELL slab (padded by -1 to n_pad rows),
        the COO tail and the hub mask [n_pad], on the rank's device. Reuses
        an injected artifact layout (``reach.persist``) when present."""
        if self._ell_dist is None:
            if self._ell_host is not None:
                ell, tsrc, tdst = self._ell_host
            else:
                ell, tsrc, tdst = self.packed.ell_layout(width=self.ell_width)
            is_hub = np.zeros(self.n_pad, dtype=bool)
            is_hub[tsrc] = True
            self._ell_dist = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (shard_rows(np.asarray(ell, np.int32), self.mesh,
                                     -1),
                          np.asarray(tsrc, np.int32),
                          np.asarray(tdst, np.int32), is_hub))
        return self._ell_dist

    def _phase2_chunk_size(self, width: int, m_t: int) -> int:
        # a data rank's chunk (key packing over n_pad, kernel 3's candidate
        # bound) times the data ranks
        local = super()._phase2_chunk_size(width, m_t, n_nodes=self.n_pad,
                                           n_blocks=self.n_dp)
        return local * self.n_dp

    def _residue_perm(self, q: int):
        """Phase-2 load balance: each chunk's residue interleaved over the
        data ranks (entry i to rank i mod D), so a residue whose difficulty
        follows query order spreads over every rank instead of landing its
        hard tail on one; the answers scatter back in ``_sparse_driver``."""
        if self.n_dp <= 1 or q <= 1:
            return None
        chunk = self._phase2_chunk_size(*self._sparse_widths())
        perm = np.empty(q, dtype=np.int64)
        for lo in range(0, q, chunk):
            m = min(chunk, q - lo)
            perm[lo:lo + m] = lo + np.argsort(
                np.arange(m, dtype=np.int64) % self.n_dp, kind="stable")
        return perm

    def _agree(self, flag: bool) -> bool:
        return self.mesh.agree(flag)

    def _expand(self, tables, cs_t, ct_t, pad, cap, max_steps, crt=None):
        ell, tsrc, tdst, is_hub = tables
        p, ovf = expand_frontier_sharded(
            self.mesh, self.dev, ell, tsrc, tdst, is_hub, cs_t, ct_t,
            torch.from_numpy(pad).to(self.device), n_nodes=self.n_pad,
            max_steps=max_steps, cap=cap, can_reach_tail=crt,
            workspaces=self._sparse_state)
        return p.numpy(), ovf

    def _expand_chunk(self, cs_t, ct_t, pad: np.ndarray, cap: int):
        return self._expand(self._ell(), cs_t, ct_t, pad, cap, self.max_steps)

    def _expand_chunk_overlay(self, cs_t, ct_t, pad: np.ndarray, cap: int):
        # the union-graph BFS depth is bounded by the node count, not the
        # base levels (delta edges may cycle across the DAG)
        ell, tsrc_u, tdst_u, hub_u, crt = self._overlay_dev()
        return self._expand((ell, tsrc_u, tdst_u, hub_u), cs_t, ct_t, pad,
                            cap, self.packed.n, crt)
