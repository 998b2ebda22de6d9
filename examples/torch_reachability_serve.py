"""End-to-end serving driver on the PyTorch/CUDA port (the paper's kind:
batched reachability requests against a size-constrained index over a
web-scale-like graph).

Builds FERRARI-G under budget k=2 on a 100k-node scale-free digraph with
SCCs, then serves 100k random + 20k positive queries through
``repro_torch.reach.QuerySession``, reporting ns/query and the phase
breakdown (paper §7.5 analogue). ``--index-dir`` persists the index on the
first run and serves from the artifact afterwards.

    PYTHONPATH=src python examples/torch_reachability_serve.py [--nodes N]

Scale-out, one process a card (``--mesh DATAxMODEL`` must match the
processes; with ``--device cpu`` the ranks talk over gloo):

    PYTHONPATH=src torchrun --nproc-per-node 2 \\
        examples/torch_reachability_serve.py --placement sharded --mesh 1x2
"""
import argparse
import contextlib

from repro_torch.launch.serve import _init_process_group, serve_reachability
from repro_torch.reach import IndexSpec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--index-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    ap.add_argument("--placement", default="single",
                    choices=["single", "replicated", "sharded"])
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL")
    args = ap.parse_args(argv)
    spec = IndexSpec(k=args.k, variant="G", placement=args.placement,
                     mesh=args.mesh)
    quiet = contextlib.nullcontext()
    if args.placement != "single":
        quiet = _init_process_group(args.device)
    with quiet:
        print("== random workload ==")
        random = serve_reachability(args.nodes, 4.0, args.queries, spec,
                                    workload="random", device=args.device,
                                    index_dir=args.index_dir)
        print("\n== positive workload ==")
        positive = serve_reachability(args.nodes, 4.0, args.queries // 5,
                                      spec, workload="positive",
                                      device=args.device,
                                      index_dir=args.index_dir)
    return {"random": random, "positive": positive}


if __name__ == "__main__":
    main()
