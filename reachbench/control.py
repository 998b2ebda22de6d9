"""The check's control: the plain reference put in the program's place with
its exactness broken, on the pairs a run of the cell would compare.

    python3 reachbench/control.py --workload web.online --hops 2 --seeds 1 2 3

For each seed it makes the cell's graph and window traffic, draws the
sample the run would compare, and answers it twice: with the reference, and
with the control (the same search cut at ``--hops`` hops, so a pair farther
apart reads "no"). It prints the control's mismatches, the number the run
holds to its limit of 0. The control must come out not correct on every
seed. The benchmark's own runs do not run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from reachbench import gen, harness, manifest, reference, traffic  # noqa: E402

HOPS = 2


def readings(m, cell_name: str, seed: int, seconds: float, hops: int,
             device, cfg=None, mix=None) -> dict:
    """The sampled pairs' count, the reachable ones, and the control's
    mismatches against the reference, for one seed."""
    cell = m.cell(cell_name)
    cfg = cfg if cfg is not None else m.config(cell)
    mix = mix if mix is not None else m.traffic(cell)
    gseed = int(seed) % (1 << 63)
    n, src, dst = gen.make_graph(cfg["graph"], gseed)
    tables = (n,) + gen.csr_arrays(n, src, dst, device)
    win = traffic.window(tables, mix, gseed, seconds)
    _, rows = harness.sampled_rows(win, mix, gseed)
    s, t = win.s[rows], win.t[rows]
    want = reference.reach_answers(n, src, dst, s, t, device=device)
    got = reference.control_answers(n, src, dst, s, t, hops, device=device)
    return {"seed": seed, "pairs": int(rows.size),
            "reachable": int(want.sum()),
            "mismatches": int((got != want).sum())}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--hops", type=int, default=HOPS)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    m = manifest.Manifest()
    seconds = float(m.data["run_seconds"])
    failed = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(m, args.workload, seed, seconds, args.hops, args.device)
        r.update(workload=args.workload, hops=args.hops,
                 seconds=time.perf_counter() - t0)
        failed += r["mismatches"] > 0
        print(json.dumps(r), flush=True)
    print(f"control: not correct on {failed} of {len(args.seeds)} seeds",
          flush=True)
    return 0 if failed == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
