#!/usr/bin/env python3
"""One 16,384-query batch of ``QuerySession.query`` on the card, or with
``--frontend PAIRS`` a ``Frontend`` serving PAIRS random pairs (8 tenants,
64-pair requests, the spec's deadline), timed for two versions of the
port in turns (A, B, B, A), each turn in a process of its own over one
saved index.

    python3 tools/batch_turns.py --a build/parent/src --b src \\
        [--nodes 1000000] [--reps 101] [--frontend 262144]

Builds ``scale_free_digraph(nodes, 4.0)`` with the default IndexSpec
using the ``--b`` tree and saves it under ``build/``; each turn loads it
with its own tree's ``repro_torch``, warms up, then times ``reps`` calls
of ``sess.query`` on the same random batch (host clock to the answers on
the host; a frontend turn times ``reps`` runs of submit-all then
``drain()``). Prints one JSON line a turn: median and quartiles in ms,
and the card's name and power limit. Both trees must read the artifact
format of ``repro_torch.reach.persist``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH = 16384


def make(src: str, path: str, nodes: int) -> None:
    sys.path.insert(0, src)
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec, build, save_index
    spec = IndexSpec()
    save_index(path, build(scale_free_digraph(nodes, 4.0, seed=0), spec),
               spec)


def serve(sess, s, t) -> None:
    """``s``, ``t`` through a ``Frontend`` on ``sess``: 8 tenants, 64-pair
    requests, polling while a tenant's queue is full, then ``drain()``."""
    from repro_torch.reach import Frontend, Rejected
    fe = Frontend(sess)
    for i, lo in enumerate(range(0, s.size, 64)):
        while True:
            try:
                fe.submit(f"tenant-{i % 8}", s[lo:lo + 64], t[lo:lo + 64])
                break
            except Rejected:
                fe.poll()
    fe.drain()


def turn(src: str, path: str, reps: int, pairs: int) -> dict:
    sys.path.insert(0, src)
    import numpy as np
    import torch

    from repro_torch.reach import QuerySession
    sess = QuerySession.load(path, device="cuda")
    n = sess.index.cond.comp.shape[0]
    rng = np.random.default_rng(1)
    s = rng.integers(0, n, pairs or BATCH)
    t = rng.integers(0, n, pairs or BATCH)
    if pairs:
        def call():
            serve(sess, s, t)
        warm = 1
    else:
        def call():
            sess.query(s, t)
        warm = 10
    for _ in range(warm):
        call()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        ms.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = (float(np.percentile(ms, p)) for p in (25, 50, 75))
    return dict(tree=src, median_ms=med, q1_ms=q1, q3_ms=q3, reps=reps,
                **({"frontend_pairs": pairs} if pairs else {}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", help="src/ of version A")
    ap.add_argument("--b", help="src/ of version B")
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=101)
    ap.add_argument("--frontend", type=int, default=0, metavar="PAIRS",
                    help="time a Frontend serving PAIRS pairs instead")
    # one step, in a process of its own: build the index, or one turn
    ap.add_argument("--index", help=argparse.SUPPRESS)
    ap.add_argument("--make", help=argparse.SUPPRESS)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.make:
        make(args.make, args.index, args.nodes)
        return 0
    if args.turn:
        print(json.dumps(turn(args.turn, args.index, args.reps,
                              args.frontend)), flush=True)
        return 0
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    me = [sys.executable, str(Path(__file__).resolve())]
    try:
        idx = str(work / "index")
        subprocess.run(me + ["--index", idx, "--nodes", str(args.nodes),
                             "--make", args.b], check=True)
        for src in (args.a, args.b, args.b, args.a):
            subprocess.run(me + ["--index", idx, "--reps", str(args.reps),
                                 "--frontend", str(args.frontend),
                                 "--turn", src], check=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
