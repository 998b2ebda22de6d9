"""Training entry point of the PyTorch/CUDA port (the dense LMs).

Wires the config registry → the train cell (``models.api.build_cell``) →
the token pipeline, and steps the model on one device: on a card the
arch's published config (flash attention through kernels 6, 7 and 8), on
the CPU its SMOKE config (the kernels' plain versions).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 3 --batch 16 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

The reference's checkpoint manager, fault injection, heartbeat, straggler
detection and elastic re-meshing are not ported (ROADMAP.md, Queue 1 item
8): ``ckpt_dir`` and ``fault_injector`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Optional

import torch

from ..configs import get_config, get_smoke
from ..configs.base import shapes_for_family
from ..core.query_torch import resolve_device
from ..data.tokens import TokenPipeline
from ..models.api import build_cell, materialize_state
from ..optim.optimizer import OptConfig


class Trainer:
    """Steps a train cell over ``TokenPipeline`` batches. ``smoke=None``
    takes the published config on a card and SMOKE on the CPU."""

    def __init__(self, arch: str, smoke: Optional[bool] = None,
                 shape: str = "train_4k", ckpt_dir: Optional[str] = None,
                 opt_cfg: Optional[OptConfig] = None, fault_injector=None,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        if ckpt_dir is not None or fault_injector is not None:
            raise NotImplementedError(
                "the checkpoint manager and fault injection of the trainer "
                "are not ported to repro_torch yet (ROADMAP.md, Queue 1 "
                "item 8)")
        self.device = resolve_device(device)
        if smoke is None:
            smoke = self.device.type == "cpu"
        self.cfg = get_smoke(arch) if smoke else get_config(arch)
        shp = shapes_for_family(self.cfg.family)[shape]
        if batch_override or seq_override:
            shp = replace(shp, batch=batch_override or shp.batch,
                          seq_len=seq_override or shp.seq_len)
        if shp.kind != "train":
            raise ValueError("Trainer drives train shapes only")
        self.shape = shp
        self.shape_name = shape
        self.opt_cfg = opt_cfg or OptConfig(warmup_steps=10)
        self.cell = build_cell(self.cfg, shape, device=self.device,
                               shape_override=shp, opt_cfg=self.opt_cfg)
        self.seed = seed
        self.pipeline = TokenPipeline(self.cfg.vocab, shp.batch, shp.seq_len,
                                      seed=seed)
        self.state = None
        self.step_idx = 0
        self.metrics: dict = {}          # the last step's, as floats
        self.history: list = []

    def init_state(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.state = materialize_state(self.cell, self.cfg, self.shape_name,
                                       gen)

    def _one_step(self) -> float:
        toks, labs = self.pipeline.batch_at(self.step_idx)
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "labels": torch.from_numpy(labs).to(self.device)}
        t0 = time.perf_counter()
        self.state, metrics = self.cell.step(self.state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.metrics = {k: float(v) for k, v in metrics.items()}
        loss = self.metrics["loss"]
        self.history.append({"step": self.step_idx, "loss": loss,
                             "seconds": dt})
        self.step_idx += 1
        return loss

    def run(self, n_steps: int, log_every: int = 10) -> list:
        """Steps until ``n_steps`` steps are done in all; returns the
        history."""
        if self.state is None:
            self.init_state()
        while self.step_idx < n_steps:
            loss = self._one_step()
            if self.step_idx % log_every == 0 or self.step_idx == n_steps:
                print(f"step {self.step_idx:5d} loss {loss:.4f} "
                      f"{self.history[-1]['seconds']:.3f}s", flush=True)
        return self.history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the published config, the CUDA kernels) or "
                         "cpu (the SMOKE config, the plain versions)")
    args = ap.parse_args(argv)
    tr = Trainer(args.arch, batch_override=args.batch, seq_override=args.seq,
                 seed=args.seed, device=args.device)
    cfg = tr.cfg
    print(f"{cfg.arch_id} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {cfg.microbatches} microbatches) on {tr.device}: "
          f"batch {tr.shape.batch} x seq {tr.shape.seq_len}", flush=True)
    hist = tr.run(args.steps, log_every=args.log_every)
    print(f"done: {len(hist)} steps, final loss {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
