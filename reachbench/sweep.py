"""Find the highest rate an open-loop cell sustains: one set-up, then the
cell's traffic at each offered rate for a window each, on the card.

    python3 reachbench/sweep.py --workload web.online --seed 11 --seconds 15 \
        --rates 400 800 1200 1600

For each rate it prints one JSON line: requests offered and refused, the
p50 and p99 of their latency (from when each was due) over the first and
the second half of the window, how late the generator ran, and how long
after the window's close the last answer came (the backlog left). A rate is
sustained when the frontend refuses nothing, the backlog drains within a
second, and neither the median nor the p99 of the second half is more than
a fifth above the first half's: the queue does not grow. Not a benchmark
run: it checks no answers and prints no result line.
"""
import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from reachbench import harness, manifest, traffic  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.reach import Frontend
    m = manifest.Manifest()
    cell = m.cell(args.workload)
    cfg, mix = m.config(cell), m.traffic(cell)
    dev = torch.device("cuda:0")
    spans = harness.Spans()
    sess, _, tables, _, host = harness.setup(
        cfg, mix, args.seed, args.seconds, dev, spans)
    print(json.dumps({"setup_s": time.perf_counter() - CLOCK0,
                      "build_index_s": host["build_index_s"],
                      "build_pack_s": host["build_pack_s"],
                      "coo_tail_edges": host["coo_tail_edges"]}), flush=True)
    for i, rate in enumerate(args.rates):
        rmix = copy.deepcopy(mix)
        rmix["rate_per_s"] = rate
        win = traffic.window(tables, rmix, args.seed + 1 + i, args.seconds)
        fe = Frontend(sess)
        sess.reset_stats()
        sent, done, refused, _ = harness.open_loop(
            fe, win, args.seconds, spans, time.perf_counter, set())
        lat = np.where(np.isnan(done), np.inf, done - win.due)
        half = win.due < args.seconds / 2
        st = fe.stats
        print(json.dumps({
            "rate_per_s": rate, "pairs_per_s": rate * win.block,
            "requests": int(win.due.size), "refused": int(refused.sum()),
            "p50_ms": [harness.percentile(lat[half], 50) * 1e3, harness.percentile(lat[~half], 50) * 1e3],
            "p99_ms": [harness.percentile(lat[half], 99) * 1e3, harness.percentile(lat[~half], 99) * 1e3],
            "late_p99_ms": harness.percentile(sent - win.due, 99) * 1e3,
            "backlog_s": float(np.nanmax(done) - args.seconds),
            "max_late_s": float(np.max(sent - win.due)),
            "slabs": st.n_batches, "occupancy": st.occupancy,
            "session": {k: v for k, v in sess.stats.as_dict().items()
                        if k.startswith(("phase", "sparse", "n_q"))}}),
            flush=True)
        print(fe.slowlog.format_report(), flush=True)
        del fe
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
