"""Sharded and elastic training of a dense LM on the PyTorch port, over
torch.distributed.

Trains tinyllama-1.1b (its SMOKE config on the CPU, its published config
on cards) with the Trainer on a (data, model) mesh of every rank laid out
by an ``ElasticMeshManager`` (``--model`` wide), committing a checkpoint
every ``--ckpt-every`` steps. At ``--fail-at`` the last of ``--workers``
workers fails (an injected ``WorkerFailure``): its ranks leave, the
survivors re-mesh (one device for one survivor) and resume from the last
committed checkpoint, each rank loading its own blocks.

Under torchrun, one process a rank (gloo with ``--device cpu``, NCCL on
cards, one card a rank by ``LOCAL_RANK``):

    PYTHONPATH=src torchrun --nproc-per-node 2 \\
        examples/torch_sharded_train.py --device cpu --model 2

Without torchrun it starts ``--nproc`` gloo ranks on the CPU itself,
joined through a FileStore in a temporary directory (no network):

    PYTHONPATH=src python examples/torch_sharded_train.py --nproc 2 --model 2
"""
import argparse
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.train import Trainer
from repro_torch.parallel import CALLS
from repro_torch.runtime.elastic import ElasticMeshManager
from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                 HeartbeatMonitor)


def train(args, device: str, ckpt_dir: str):
    """Every rank: the elastic Trainer, then the outcome from rank 0."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mgr = ElasticMeshManager(prefer_model=args.model, device=device)
    mesh = mgr.current_mesh()
    fault = (FaultInjector.worker_failure_at(args.fail_at,
                                             worker=args.workers - 1)
             if args.fail_at else None)
    tr = Trainer(args.arch, device=device, mesh=mesh, elastic=mgr,
                 ckpt_dir=ckpt_dir, fault_injector=fault,
                 batch_override=args.batch, seq_override=args.seq)
    tr.monitor = HeartbeatMonitor(n_workers=args.workers, timeout_s=3600)
    if rank == 0:
        cfg = tr.cfg
        print(f"{cfg.arch_id} ({cfg.n_layers} layers, d_model {cfg.d_model},"
              f" {cfg.dtype}) on {world} ranks, mesh "
              f"{dict(mesh.sizes) if mesh else 'one device'}, batch "
              f"{tr.shape.batch} x {tr.shape.seq_len}", flush=True)
    tr.restore_or_init()
    CALLS.clear()
    tr.run(args.steps, ckpt_every=args.ckpt_every, log_every=1)
    if tr.left:
        print(f"rank {rank} left at step {tr.step_idx} (worker "
              f"{args.workers - 1}'s)", flush=True)
    dist.barrier()
    if rank == 0:
        print(f"trained {tr.step_idx} steps with {tr.recoveries} "
              f"recovery(ies), mesh generation {mgr.generation}, ending on "
              f"{dict(tr.mesh.sizes) if tr.mesh else 'one device'}; "
              f"collectives since the start {dict(sorted(CALLS.items()))}",
              flush=True)


def spawned(rank: int, world: int, store: str, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    try:
        train(args, "cpu", os.path.join(os.path.dirname(store), "ckpt"))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card a rank) or cpu (gloo)")
    ap.add_argument("--nproc", type=int, default=2,
                    help="without torchrun: gloo ranks to start")
    ap.add_argument("--model", type=int, default=2,
                    help="the mesh's preferred model width")
    ap.add_argument("--workers", type=int, default=2,
                    help="workers the ranks split into (contiguous)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--fail-at", type=int, default=3,
                    help="the step the last worker fails at (0: never)")
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    if "RANK" not in os.environ:          # not under torchrun
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(spawned, args=(args.nproc, os.path.join(tmp, "store"),
                                    args), nprocs=args.nproc, join=True)
        return
    cpu = args.device == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    try:
        train(args, "cpu" if cpu else "cuda", box[0])
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(box[0], ignore_errors=True)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
