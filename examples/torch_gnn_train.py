"""GNN training with FERRARI as a first-class data-path feature, on the
PyTorch/CUDA port.

Trains gcn-cora through ``models.gnn.forward_full`` on a synthetic
Cora-like citation DAG. The link-prediction negative sampler consults the
``ReachabilityService`` so 'negative' pairs are GUARANTEED unreachable —
the paper's index as infrastructure (on a card kernel 1, and kernels 3
and 4 wherever phase 2 runs).

    PYTHONPATH=src python examples/torch_gnn_train.py [--device cpu] [--steps 100]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.graph_data import ReachabilityService, synthetic_dataset
from repro_torch.models import gnn
from repro_torch.models.api import value_and_grad
from repro_torch.models.common import cross_entropy
from repro_torch.optim.optimizer import OptConfig, adamw_init, adamw_update


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--pairs", type=int, default=4000)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    g, feats, labels, n_classes = synthetic_dataset("cora")
    print(f"graph: n={g.n} m={g.m}, d_feat={feats.shape[1]}")

    svc = ReachabilityService(g, k=2, device=args.device)
    rng = np.random.default_rng(0)
    cand_s = rng.integers(0, g.n, args.pairs)
    cand_t = rng.integers(0, g.n, args.pairs)
    neg_s, neg_t = svc.filter_unreachable_pairs(cand_s, cand_t)
    print(f"negative sampler: {len(neg_s)}/{args.pairs} candidate pairs "
          f"verified unreachable by FERRARI (k=2) on {dev}")

    cfg = get_smoke("gcn-cora")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = gnn.init_params(cfg, gen, feats.shape[1], n_classes, dev)
    opt = adamw_init(params)
    ocfg = OptConfig(lr=1e-2, warmup_steps=5, total_steps=100)
    src, dst = g.edges()
    src_t = torch.from_numpy(src.astype(np.int32)).to(dev)
    dst_t = torch.from_numpy(dst.astype(np.int32)).to(dev)
    feats_t = torch.from_numpy(feats).to(dev)
    labels_t = torch.from_numpy(labels).to(dev)

    def loss_fn(p):
        logits = gnn.forward_full(cfg, p, feats_t, src_t, dst_t, g.n)
        return cross_entropy(logits, labels_t)

    t0 = time.time()
    for i in range(args.steps):
        loss, grads = value_and_grad(loss_fn, params)
        params, opt, _ = adamw_update(ocfg, params, grads, opt)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:3d} loss {float(loss):.4f}")
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
