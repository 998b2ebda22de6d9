"""Dry run: every (arch × shape × mesh) cell's step evaluated on ``meta``
tensors, on a fake process group the size of the production mesh.

For each cell of ``configs.registry.ARCHS`` × ``shapes_for_family`` (42
cells) at its published config, and for rank 0 and the mesh's last rank:

    fake process group of 256 (16x16) or 512 (2x16x16) ranks, this rank
    cell  = build_cell(cfg, shape, mesh=make_production_mesh(device="meta"))
    state = the rank's blocks of the state (materialize_state on meta)
    batch = the whole batch on meta (a step cuts the rank's block itself)
    cell.step(state, batch) under FlopCounterMode, a MemTracker and a
    per-op byte count

and a JSON artifact is written to
``artifacts/dryrun_torch/<mesh>/<arch>/<shape>.json``, with the
reference's keys where a counterpart exists:

  * ``flops``: the aten ops' FLOPs (``FlopCounterMode``'s formulas) plus
    the hand-written kernels' operations (``kernels.work``);
  * ``bytes_accessed``: the input and output bytes of every aten op but
    views, allocations and collectives, plus the kernels' bytes;
  * ``memory``: ``argument_bytes`` (the rank's blocks of state and batch
    under ``state_shardings()`` / ``batch_shardings()``), ``output_bytes``
    (every tensor the step returns), ``peak_bytes`` (the MemTracker's
    peak over the step, the whole batch and the state included) and
    ``temp_bytes`` (the peak less what was live when the step began);
  * ``collectives``: ``{kind: {count, bytes}, total_bytes}`` from
    ``parallel.KINDS`` / ``KIND_BYTES`` (the reference's kind names; an
    all-gather's bytes are its whole output, as the reference sums the
    result shapes);
  * ``kernels``: per kernel, the launches the card would make and their
    flops and bytes (``work.TALLY``: on ``meta`` a wrapper allocates its
    outputs, records the call and launches nothing);
  * ``model_flops``, ``analysis``, ``ok``, ``kind``, ``seconds_total``,
    ``error``, ``traceback``; ``ranks`` holds each run rank's figures.

The reference compiles each LM cell twice, its scanned production form
and an unrolled analysis form whose cost analysis counts every layer's
trips. Eager execution runs every layer's real trips, so one run gives
both: ``analysis`` is a copy of the same run's ``flops``,
``bytes_accessed`` and ``collectives``, as the reference's is for its
non-LM archs (``--no-analysis`` is accepted and changes nothing). The
XLA-only keys (compile seconds, generated code, HLO lines) have no
counterpart. ``--mesh none`` runs one device, no mesh and no process
group. A failing cell records its error, and the run exits non-zero.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both        # all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, bmm_flop

from ..configs.base import shapes_for_family
from ..configs.registry import ARCHS, get_config
from ..kernels import work
from ..models import api
from ..parallel import collectives
from ..parallel import sharding as shd
from .mesh import Mesh, make_production_mesh

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
# a mesh kind: the production meshes, or "none" (one device, no process
# group); ``dry_cell`` also takes an explicit (shape, axis names)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "none": ((), ())}
PORT = str(Path(__file__).resolve().parents[1])
# frames an op is not attributed to: the profilers, and the collectives'
# helpers (a collective or its copy goes to the line that asked for it)
_SELF = (__file__, str(Path(__file__).with_name("opprof.py")),
         str(Path(PORT) / "parallel" / "collectives.py"))


def _bmm_flop(a_shape, b_shape, *rest, out_shape=None, **kw) -> int:
    # aten.bmm.dtype (bmm with out_dtype) carries the dtype third, which
    # the stock formula takes for out_shape
    return bmm_flop(a_shape, b_shape)


def flop_counter() -> FlopCounterMode:
    """``FlopCounterMode`` with the product of a reduced-precision pair
    into float32 (``aten.bmm.dtype``, the decode attention's) counted as
    a bmm: the counter both the dry run and a real step on the card
    read."""
    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.bmm: _bmm_flop})


# ------------------------------------------------------------- per-op count

_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _where() -> str:
    """``file:function:line`` of the innermost frame in the port's own
    code (``_SELF`` aside), the file relative to the package."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(PORT) and name not in _SELF:
            return (f"{name[len(PORT) + 1:]}:{f.f_code.co_name}:"
                    f"{f.f_lineno}")
        f = f.f_back
    return "<outside the port>"


class OpCounter(TorchDispatchMode):
    """Counts every aten op's input and output bytes (views, allocations
    and collectives aside) and, with ``where``, attributes each op's
    FLOPs and bytes and each collective's bytes to the innermost frame of
    the port that made it (``rows``: name -> {"count", "flops",
    "bytes"}; ``coll``: "kind :: frame" -> bytes)."""

    def __init__(self, where: bool = False):
        super().__init__()
        self.where = where
        self.bytes = 0
        self.rows = defaultdict(lambda: {"count": 0, "flops": 0, "bytes": 0})
        self.coll = defaultdict(int)
        self._flops = flop_counter().flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            if self.where:
                self.coll[f"{func.overloadpacket.__name__} :: "
                          f"{_where()}"] += _nbytes(out)
            return out
        if func.is_view or func.overloadpacket.__name__ in _ALLOC:
            return out
        nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self.bytes += nbytes
        if self.where:
            packet = func.overloadpacket
            flops = (self._flops[packet](*args, **kwargs, out_val=out)
                     if packet in self._flops else 0)
            row = self.rows[_where()]
            row["count"] += 1
            row["flops"] += int(flops)
            row["bytes"] += nbytes
        return out


# ---------------------------------------------------------- abstract state

def abstract_state(cell, cfg):
    """The rank's state of ``cell`` (built on ``meta``): the params (and
    cache, and AdamW's m and v) drawn on ``meta`` and cut to the rank's
    blocks by ``materialize_state``; ferrari's tables as ``meta`` tensors
    of the cell's state shapes (the rank's rows on a sharded mesh)."""
    if cfg.family == "ferrari":
        return {k: torch.empty(s, dtype=d, device="meta")
                for k, (s, d) in cell.state_shapes.items()}
    return api.materialize_state(cell, cfg, cell.shape_name,
                                 torch.Generator("cpu"))


def abstract_batch(cell):
    """The whole batch of ``cell`` on ``meta``; decode's position a host
    int32 at the cache's last position."""
    out = {}
    for k, (shape, dtype) in cell.batch_shapes.items():
        if k == "pos":
            out[k] = torch.tensor(cell.shape.seq_len - 1, dtype=dtype)
        else:
            out[k] = torch.empty(shape, dtype=dtype, device="meta")
    return out


def argument_bytes(cell, state, batch) -> int:
    """The rank's blocks of the step's arguments: the state as given (it
    is the rank's blocks), the batch under ``batch_shardings()``."""
    pl = cell.batch_shardings()
    total = _nbytes(state)
    for k, t in batch.items():
        shape = (tuple(t.shape) if pl is None else
                 shd.local_shape(tuple(t.shape), pl[k].spec, cell.mesh))
        n = 1
        for d in shape:
            n *= d
        total += n * t.element_size()
    return total


# ------------------------------------------------------------------ a step

_COUNTERS = (work.TALLY, collectives.CALLS, collectives.BYTES,
             collectives.KINDS, collectives.KIND_BYTES)


@contextlib.contextmanager
def _own_counters():
    """The kernels' tally and the collectives' counters cleared for one
    run and given back as they were after it, so that a dry run leaves
    no count behind in the process."""
    saved = [dict(c) for c in _COUNTERS]
    for c in _COUNTERS:
        c.clear()
    try:
        yield
    finally:
        for c, before in zip(_COUNTERS, saved):
            c.clear()
            c.update(before)


def measure(cell, state, batch, where: bool = False) -> dict:
    """Run ``cell.step(state, batch)`` on ``meta`` tensors once and return
    its figures (the module docstring); with ``where``, also the per-op
    rows of ``OpCounter`` under "op_rows" and "coll_rows"."""
    from torch.distributed._tools.mem_tracker import MemTracker
    args = argument_bytes(cell, state, batch)
    live = _nbytes(state) + _nbytes(batch)
    mt = MemTracker()
    mt.track_external(*[t for t in _tensors((state, batch))
                        if t.device.type == "meta"])
    ops = OpCounter(where)
    fc = flop_counter()
    with _own_counters():
        with mt, fc, ops:
            new_state, out = cell.step(state, batch)
        kernels = {k: dict(v) for k, v in work.TALLY.items()}
        coll = {k: {"count": int(collectives.KINDS[k]),
                    "bytes": int(collectives.KIND_BYTES[k])}
                for k in sorted(collectives.KINDS)}
    peak = sum(v["Total"] for dev, v in mt.get_tracker_snapshot("peak").items()
               if torch.device(dev).type == "meta")
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    aten_flops = int(fc.get_total_flops())
    rec = {
        "flops": aten_flops + sum(v["flops"] for v in kernels.values()),
        "aten_flops": aten_flops,
        "bytes_accessed": ops.bytes + sum(v["bytes"]
                                          for v in kernels.values()),
        "memory": {"argument_bytes": int(args),
                   "output_bytes": int(_nbytes((new_state, out))),
                   "temp_bytes": int(max(peak - live, 0)),
                   "peak_bytes": int(max(peak, live))},
        "collectives": coll,
        "kernels": kernels,
    }
    if where:
        rec["op_rows"] = {k: dict(v) for k, v in ops.rows.items()}
        rec["coll_rows"] = dict(ops.coll)
    return rec


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A ``fake`` process group of ``world`` ranks as ``rank`` (no
    process, no network; its collectives return at once), destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _one_rank(cfg, shape_name, mesh, rules, shape_override, where):
    cell = api.build_cell(cfg, shape_name, device="meta", mesh=mesh,
                          rules=rules, shape_override=shape_override)
    state = abstract_state(cell, cfg)
    return cell, measure(cell, state, abstract_batch(cell), where)


def mesh_of(mesh_kind):
    """(shape, axis names, world) of a mesh kind or of an explicit (shape,
    axis names)."""
    shape, axes = (MESHES[mesh_kind] if isinstance(mesh_kind, str)
                   else mesh_kind)
    world = 1
    for s in shape:
        world *= s
    return tuple(shape), tuple(axes), world


def ranks_of(mesh_kind) -> tuple:
    """The ranks a mesh's dry run evaluates: the first and the last."""
    world = mesh_of(mesh_kind)[2]
    return (0,) if world == 1 else (0, world - 1)


def dry_cell(cfg, shape_name: str, mesh_kind, rank: int = 0, rules=None,
             shape_override=None, where: bool = False):
    """(cell, figures) of one rank of a cell (``measure``) on a fake
    process group of the mesh's size; ``mesh_kind`` "none": one device,
    no mesh, no process group."""
    shape, axes, world = mesh_of(mesh_kind)
    if not shape:
        return _one_rank(cfg, shape_name, None, rules, shape_override, where)
    with fake_world(world, rank):
        if mesh_kind in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device="meta")
        else:
            mesh = Mesh(shape, axes, device="meta")
        return _one_rank(cfg, shape_name, mesh, rules, shape_override,
                         where)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             rules: dict | None = None, save: bool = True, cfg=None,
             shape_override=None) -> dict:
    """Evaluate a cell on ``mesh_kind`` ("single", "multi" or "none") for
    each of ``ranks_of(mesh_kind)`` and return (and with ``save`` write)
    its record; ``cfg`` / ``shape_override`` replace the published config
    and shape (a cut)."""
    cfg = cfg or get_config(arch)
    shape, axes, n_dev = mesh_of(mesh_kind)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "mesh_shape": dict(zip(axes, shape)), "n_devices": n_dev,
                 "ok": False}
    t0 = time.time()
    try:
        ranks = {}
        for rank in ranks_of(mesh_kind):
            cell, fig = dry_cell(cfg, shape_name, mesh_kind, rank, rules,
                                 shape_override)
            ranks[str(rank)] = fig
        rec.update(ranks["0"])
        rec["kind"] = cell.kind
        rec["model_flops"] = (int(cell.model_flops_fn())
                              if cell.model_flops_fn else None)
        rec["analysis"] = {k: rec[k] for k in
                           ("flops", "bytes_accessed", "collectives")}
        rec["ranks"] = ranks
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded, the run fails loudly
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["seconds_total"] = round(time.time() - t0, 2)
    if save:
        d = ART_DIR / mesh_kind / arch
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{shape_name}.json").write_text(json.dumps(rec, indent=1))
    return rec


def iter_cells(archs=None, shapes=None):
    for arch in (archs or ARCHS):
        for shape_name in shapes_for_family(get_config(arch).family):
            if shapes and shape_name not in shapes:
                continue
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", choices=["single", "multi", "both", "none"],
                    default="both")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="accepted for the reference's CLI: one eager run "
                         "already counts every layer's trips")
    args = ap.parse_args(argv)
    meshes = {"single": ["single"], "multi": ["multi"], "none": ["none"],
              "both": ["single", "multi"]}[args.mesh]
    failures = []
    for mesh_kind in meshes:
        for arch, shape_name in iter_cells(args.arch, args.shape):
            out = ART_DIR / mesh_kind / arch / f"{shape_name}.json"
            if args.skip_existing and out.exists():
                if json.loads(out.read_text()).get("ok"):
                    print(f"[skip] {mesh_kind}/{arch}/{shape_name}")
                    continue
            rec = run_cell(arch, shape_name, mesh_kind)
            status = "OK " if rec["ok"] else "FAIL"
            extra = rec.get("error", "")
            if rec["ok"]:                 # rank 0, and the last rank's peak
                peaks = "/".join(f"{r['memory']['peak_bytes'] / 1e9:.3f}"
                                 for r in rec["ranks"].values())
                extra = (f"flops={rec['flops']:.4g} "
                         f"coll={rec['collectives']['total_bytes']:.4g}B "
                         f"peak={peaks}GB")
            print(f"[{status}] {mesh_kind}/{arch}/{shape_name} "
                  f"({rec['seconds_total']}s) {extra}", flush=True)
            if not rec["ok"]:
                failures.append((mesh_kind, arch, shape_name))
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall dry-run cells ran OK")


if __name__ == "__main__":
    main()
