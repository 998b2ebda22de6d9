"""Expert-parallel MoE training on the PyTorch port, over torch.distributed.

Trains moonshot-v1-16b-a3b's SMOKE config (8 experts, top 2, capacity
factor 8, so nothing drops) for a few steps twice on a 2x2 (data, model)
mesh of four gloo ranks on the CPU, one process each, joined through a
FileStore in a temporary directory (no network): once with the gather
dispatch (every rank gathers the 8 experts from the blocks the
reference's placement gives it and runs them on its data block), once
expert-parallel (each model rank runs its 4 experts, and the partial
combines are summed over the model group). Both run attention
tensor-parallel over 'model', average the gradients over the data ranks
and update ZeRO-1 blocks of m and v. The loss trajectories coincide;
the collectives a step differ, as the port's own collective functions
count them (``repro_torch.parallel.CALLS``).

The mesh is 2x2, where the JAX package's example takes 2x4 on 8 virtual
devices: each rank here is a process with its own interpreter, and four
keep the example light while both axes still have more than one rank.

    PYTHONPATH=src python examples/torch_moe_expert_parallel.py [--steps 8]
"""
import argparse
import os
import tempfile
from dataclasses import replace

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.core.distributed import ServingMesh
from repro_torch.data import TokenPipeline
from repro_torch.models.api import build_cell, materialize_state
from repro_torch.optim.optimizer import OptConfig
from repro_torch.parallel import CALLS

ARCH = "moonshot-v1-16b-a3b"
MESH = (2, 2)
BATCH, SEQ = 8, 32


def run(impl: str, mesh, steps: int):
    """(losses, the last step's collective calls) of ``steps`` train
    steps with the ``impl`` dispatch."""
    cfg = get_smoke(ARCH)
    cfg = replace(cfg, moe=replace(cfg.moe, dispatch="sort", impl=impl,
                                   capacity_factor=8.0))
    shape = replace(shapes_for_family("lm")["train_4k"], batch=BATCH,
                    seq_len=SEQ)
    cell = build_cell(cfg, "train_4k", mesh=mesh, shape_override=shape,
                      opt_cfg=OptConfig(warmup_steps=2))
    state = materialize_state(cell, cfg, "train_4k",
                              torch.Generator().manual_seed(0))
    pipe = TokenPipeline(cfg.vocab, BATCH, SEQ, seed=1)
    losses = []
    for step in range(steps):
        toks, labs = pipe.batch_at(step)
        CALLS.clear()
        state, metrics = cell.step(state, {"tokens": torch.from_numpy(toks),
                                           "labels": torch.from_numpy(labs)})
        losses.append(float(metrics["loss"]))
    return losses, dict(sorted(CALLS.items()))


def worker(rank: int, world: int, store: str, steps: int):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    try:
        mesh = ServingMesh("sharded", MESH, "cpu")
        l_gather, c_gather = run("gather", mesh, steps)
        l_ep, c_ep = run("shard_map", mesh, steps)
    finally:
        dist.destroy_process_group()
    if rank:
        return
    print(f"{ARCH} SMOKE on a {MESH[0]}x{MESH[1]} (data, model) mesh of "
          f"{world} gloo ranks, batch {BATCH} x {SEQ}")
    print(f"{'step':>4}  {'gather-loss':>12}  {'expert-parallel-loss':>20}")
    for i, (a, b) in enumerate(zip(l_gather, l_ep)):
        print(f"{i:>4}  {a:>12.6f}  {b:>20.6f}")
    drift = max(abs(a - b) for a, b in zip(l_gather, l_ep))
    print(f"\nmax loss drift: {drift:.3e} (same math, different dispatch)")
    print(f"collective calls a step  gather:          {c_gather}")
    print(f"collective calls a step  expert-parallel: {c_ep}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    world = MESH[0] * MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(worker, args=(world, os.path.join(tmp, "store"),
                               args.steps), nprocs=world, join=True)


if __name__ == "__main__":
    main()
