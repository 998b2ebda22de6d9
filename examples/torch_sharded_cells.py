"""Serving and GNN cells on a mesh on the PyTorch port, over
torch.distributed.

On a 1x2 (data, model) mesh of two gloo ranks on the CPU (one process
each, joined through a FileStore in a temporary directory, no network):
tinyllama-1.1b's SMOKE config prefills a prompt tensor-parallel (each
rank attends with half the heads) and decodes greedily with its cache's
sequence split over the two ranks (flash-decoding: each rank's partial
softmax, combined over the pair); then gin-tu takes one train step on a
2x1 mesh of the same ranks, each rank a block of the graph's nodes and
edges. Both are run again on one device, and rank 0 prints the two side
by side.

    PYTHONPATH=src python examples/torch_sharded_cells.py [--steps 8]
"""
import argparse
import os
import tempfile
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.parallel import CALLS

PROMPT, MAX_SEQ = 24, 32


def decode(mesh, steps: int):
    """(greedy tokens, the last step's logits) of a prefill and ``steps``
    decode steps of tinyllama's SMOKE config on ``mesh`` (or one
    device)."""
    cfg = get_smoke("tinyllama-1.1b")
    lm = shapes_for_family("lm")
    cell = api.build_cell(cfg, "decode_32k", device="cpu", mesh=mesh,
                          shape_override=replace(lm["decode_32k"], batch=1,
                                                 seq_len=MAX_SEQ))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = api.shard_state(cell, {"params": params})
    prompt = torch.randint(0, cfg.vocab, (1, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = tf.prefill(cfg, state["params"], prompt, MAX_SEQ,
                               tp=cell.tp, shard=cell.cache_shard)
    state["cache"] = cache
    out = []
    for i in range(steps):
        token = logits.argmax(-1, keepdim=True).to(torch.int32)
        out.append(int(token[0, 0]))
        state, logits = cell.step(state, {"token": token,
                                          "pos": torch.tensor(PROMPT + i)})
    return out, logits


def gnn_step(mesh):
    """The loss and grad_norm of one gin-tu full-graph train step."""
    cfg = get_smoke("gin-tu")
    shp = replace(shapes_for_family("gnn")["ogb_products"], n_nodes=1000,
                  n_edges=4000, d_feat=16, n_classes=4)
    cell = api.build_cell(cfg, "ogb_products", device="cpu", mesh=mesh,
                          shape_override=shp)
    state = api.materialize_state(cell, cfg, "ogb_products",
                                  torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    (n, d), _ = cell.batch_shapes["feats"]
    m = cell.batch_shapes["src"][0][0]
    batch = {"feats": torch.from_numpy(rng.standard_normal((n, d)).astype(
                 np.float32)),
             "src": torch.from_numpy(rng.integers(0, n, m, dtype=np.int32)),
             "dst": torch.from_numpy(rng.integers(0, n, m, dtype=np.int32)),
             "labels": torch.from_numpy(rng.integers(-1, 4, n,
                                                     dtype=np.int32))}
    _, metrics = cell.step(state, batch)
    return float(metrics["loss"]), float(metrics["grad_norm"])


def worker(rank: int, world: int, store: str, steps: int):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    try:
        tp_mesh = Mesh((1, 2), ("data", "model"), device="cpu")
        CALLS.clear()
        toks, logits = decode(tp_mesh, steps)
        calls = dict(sorted(CALLS.items()))
        CALLS.clear()
        dp_mesh = Mesh((2, 1), ("data", "model"), device="cpu")
        loss, gnorm = gnn_step(dp_mesh)
        gnn_calls = dict(sorted(CALLS.items()))
    finally:
        dist.destroy_process_group()
    if rank:
        return
    one_toks, one_logits = decode(None, steps)
    one_loss, one_gnorm = gnn_step(None)
    err = float((logits - one_logits).abs().max())
    print(f"tinyllama-1.1b SMOKE, a {PROMPT}-token prompt on a 1x2 mesh of "
          f"{world} gloo ranks: the cache's {MAX_SEQ} positions split "
          f"{MAX_SEQ // 2} a rank")
    print(f"  greedy tokens on the mesh:  {toks}")
    print(f"  greedy tokens, one device:  {one_toks}")
    print(f"  last logits' max difference: {err:.3e}")
    print(f"  collectives: {calls}")
    print(f"gin-tu full graph on a 2x1 mesh: loss {loss:.6f} grad_norm "
          f"{gnorm:.6f}; one device: loss {one_loss:.6f} grad_norm "
          f"{one_gnorm:.6f}")
    print(f"  collectives: {gnn_calls}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(worker, args=(2, os.path.join(tmp, "store"), args.steps),
                 nprocs=2, join=True)


if __name__ == "__main__":
    main()
