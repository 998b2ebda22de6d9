"""Op profile: per-source-line FLOP, byte and collective attribution of a
cell's step, the counterpart of the reference's HLO profiler.

The dry run (``launch.dryrun``) gives a cell's totals; this tool runs the
same ``meta`` step on the same fake process group and attributes

    * each aten op's FLOPs (``FlopCounterMode``'s formulas) and its input
      and output bytes (views and allocations aside),
    * each collective's result bytes, by kind,

to the innermost frame of the port that made the op (``file:function:
line``, the file relative to ``repro_torch``). Every layer runs the same
lines, so all the layers of one einsum fold into one row, as the
reference's ``_trim_op_name`` folds its unrolled layers. Each
hand-written kernel is a row of its own (``kernel <name>``), with the
operations and bytes ``kernels.work`` counts for its calls.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.opprof \\
        --arch moonshot-v1-16b-a3b --shape train_4k [--mesh single] [--top 30]
"""
from __future__ import annotations

import argparse

from ..configs.registry import get_config
from .dryrun import dry_cell, mesh_of


def profile(fig: dict, top: int = 30) -> dict:
    """The three tables of one rank's figures (``dryrun.measure`` with
    ``where``): FLOPs and bytes by row, the kernels among them, and
    collective bytes by kind and row."""
    rows = dict(fig["op_rows"])
    for name, k in fig["kernels"].items():
        rows[f"kernel {name}"] = {"count": k["launches"],
                                  "flops": k["flops"], "bytes": k["bytes"]}
    flops = {k: v["flops"] for k, v in rows.items() if v["flops"]}
    return {
        "total_dot_flops": sum(flops.values()),
        "flops_top": sorted(flops.items(), key=lambda kv: -kv[1])[:top],
        "flops_counts": {k: v["count"] for k, v in rows.items()},
        "bytes_top": sorted(((k, v["bytes"]) for k, v in rows.items()),
                            key=lambda kv: -kv[1])[:top],
        "coll_top": sorted(fig["coll_rows"].items(),
                           key=lambda kv: -kv[1])[:top],
        "n_rows": len(rows),
        "aten_flops": fig["aten_flops"],
        "bytes_accessed": fig["bytes_accessed"],
    }


def report(prof: dict, model_flops_per_chip: float | None = None,
           file=None) -> None:
    p = lambda *a: print(*a, file=file)                 # noqa: E731
    tot = prof["total_dot_flops"]
    p(f"total FLOPs (per rank, aten ops and kernels): {tot:.4g}")
    if model_flops_per_chip:
        p(f"model FLOPs/chip: {model_flops_per_chip:.4g} "
          f"(useful frac of FLOPs: {model_flops_per_chip / max(tot, 1):.4f})")
    p("\n--- top FLOPs by source line ---")
    for name, f in prof["flops_top"]:
        n = prof["flops_counts"][name]
        p(f"{f:>14.4g}  ({f / max(tot, 1):6.2%})  x{n:<5d} {name}")
    p("\n--- top bytes by source line (op inputs + outputs) ---")
    for name, b in prof["bytes_top"]:
        p(f"{b / 2**30:>10.3f} GiB  {name}")
    p("\n--- collective bytes by kind and source line ---")
    for name, b in prof["coll_top"]:
        p(f"{b / 2**20:>10.2f} MiB  {name}")


def profile_cell(arch: str, shape_name: str, mesh_kind: str = "single",
                 top: int = 30, rules=None, cfg=None, shape_override=None):
    """(profile, model FLOPs per rank) of rank 0 of a cell on
    ``mesh_kind`` ("single", "multi" or "none"); ``cfg`` /
    ``shape_override`` replace the published config and shape."""
    cfg = cfg or get_config(arch)
    cell, fig = dry_cell(cfg, shape_name, mesh_kind, 0, rules,
                         shape_override, where=True)
    n_dev = mesh_of(mesh_kind)[2]
    mf = cell.model_flops_fn() / n_dev if cell.model_flops_fn else None
    return profile(fig, top), mf


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["single", "multi", "none"],
                    default="single")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    prof, mf = profile_cell(args.arch, args.shape, args.mesh, top=args.top)
    print(f"aten FLOPs={prof['aten_flops']:.4g} "
          f"bytes={prof['bytes_accessed']:.4g} rows={prof['n_rows']}")
    report(prof, mf)


if __name__ == "__main__":
    main()
