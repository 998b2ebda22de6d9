"""Fault-tolerant training entry point of the PyTorch/CUDA port (the
dense and MoE LMs).

Wires the config registry → the train cell (``models.api.build_cell``) →
the token pipeline → the checkpoint manager → the heartbeat and straggler
monitors, and steps the model on one device or, given a mesh
(``launch.mesh.Mesh``, one process a rank, ranks the caller starts), the
LM sharded over it (dense or MoE): on a card the arch's published config (flash
attention through kernels 6, 7 and 8), on the CPU its SMOKE config (the
kernels' plain versions). The supervisor loop (``Trainer.run``) catches
``WorkerFailure`` / ``Preemption``, rolls back to the last committed
checkpoint and resumes. With ``elastic`` (a ``runtime.elastic.
ElasticMeshManager``) a ``WorkerFailure`` also re-meshes: the worker's
ranks are excluded, every rank lays out the survivors' mesh (its process
groups are made while every rank is still there), an excluded rank
returns from ``run``, and the survivors rebuild the cell on the new mesh
(one device for one survivor) and restore the last committed checkpoint
onto it, each its own blocks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 3 --batch 16 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 \
        --ckpt-dir build/ckpt --ckpt-every 5

The command line trains on one device, as the reference's does;
``examples/torch_sharded_train.py`` drives the Trainer on a mesh under
``torchrun``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Optional

import torch
import torch.distributed as dist

from ..checkpoint.checkpoint import CheckpointManager
from ..configs import get_config, get_smoke
from ..configs.base import shapes_for_family
from ..core.query_torch import resolve_device
from ..data.tokens import TokenPipeline
from ..models.api import build_cell, materialize_state
from ..optim.optimizer import OptConfig
from ..runtime.fault_tolerance import (FaultInjector, HeartbeatMonitor,
                                       Preemption, StragglerDetector,
                                       WorkerFailure)


class Trainer:
    """Steps a train cell over ``TokenPipeline`` batches. ``smoke=None``
    takes the published config on a card and SMOKE on the CPU.
    ``ckpt_dir``: where ``run`` commits checkpoints and ``restore_or_init``
    finds them; ``fault_injector``: scripted failures (tests, examples).
    ``cfg_override``: a config to train instead of the arch's (a cut).
    ``mesh``: train the LM sharded over it (a dense LM's layer
    tensor-parallel, an MoE LM's attention over 'model' and its experts
    expert-parallel; its device is the Trainer's; every rank of it runs
    the same Trainer on the same batches); ``elastic``: re-mesh on a
    ``WorkerFailure``."""

    def __init__(self, arch: str, smoke: Optional[bool] = None,
                 shape: str = "train_4k", ckpt_dir: Optional[str] = None,
                 opt_cfg: Optional[OptConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None, seed: int = 0,
                 device="cuda", cfg_override=None, mesh=None, elastic=None):
        self.mesh = mesh
        self.elastic = elastic
        self.left = False                # excluded by an elastic re-mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        if smoke is None:
            smoke = self.device.type == "cpu"
        self.cfg = cfg_override or (get_smoke(arch) if smoke
                                    else get_config(arch))
        shp = shapes_for_family(self.cfg.family)[shape]
        if batch_override or seq_override:
            shp = replace(shp, batch=batch_override or shp.batch,
                          seq_len=seq_override or shp.seq_len)
        if shp.kind != "train":
            raise ValueError("Trainer drives train shapes only")
        self.shape = shp
        self.shape_name = shape
        self.opt_cfg = opt_cfg or OptConfig(warmup_steps=10)
        self.cell = self._build_cell()
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.monitor = HeartbeatMonitor(n_workers=1, timeout_s=3600)
        self.straggler = StragglerDetector()
        self.injector = fault_injector
        self.seed = seed
        self.pipeline = TokenPipeline(self.cfg.vocab, shp.batch, shp.seq_len,
                                      seed=seed)
        self.state = None
        self.step_idx = 0
        self.recoveries = 0
        self.metrics: dict = {}          # the last step's, as floats
        self.history: list = []

    def _build_cell(self):
        # rebuilt after every failure (the re-mesh hook)
        return build_cell(self.cfg, self.shape_name, device=self.device,
                          shape_override=self.shape, opt_cfg=self.opt_cfg,
                          mesh=self.mesh)

    # ----------------------------------------------------------- lifecycle
    def _fresh_state(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        return materialize_state(self.cell, self.cfg, self.shape_name, gen)

    def init_state(self):
        self.state = self._fresh_state()

    def restore_or_init(self) -> bool:
        """The last committed checkpoint's state and data cursor (True), or
        a fresh state (False)."""
        if self.ckpt is not None:
            like = self.state if self.state is not None else \
                self._fresh_state()
            restored, manifest = self.ckpt.restore_latest(
                like, self.cell.state_shardings())
            if restored is not None:
                self.state = restored
                self.step_idx = manifest["extra"]["data_state"]["step"]
                return True
            if self.state is None:
                self.state = like
                return False
        self.init_state()
        return False

    def _save(self):
        self.ckpt.save(self.step_idx, self.state, extra={
            "data_state": self.pipeline.state(self.step_idx)},
            mesh=self.mesh, placements=self.cell.state_shardings())

    def _says(self) -> bool:
        """Whether this rank prints (the mesh's first rank, or no mesh)."""
        return self.mesh is None or self.mesh.rank == self.mesh.ranks[0]

    def _settle(self):
        """Wait for the checkpoint in flight (its writer's), then for every
        rank of the mesh, so that all of them restore the same step."""
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.mesh is not None:
            group = self.mesh.group(self.mesh.axis_names)
            if group is not None:
                dist.barrier(group=group)

    def _remesh(self, worker: int) -> bool:
        """Exclude ``worker``'s ranks and lay the survivors' mesh out (on
        every rank of the old mesh). False where this rank is no longer
        in it."""
        self.elastic.exclude(self.elastic.devices_of_worker(
            worker, self.monitor.n_workers))
        self.mesh = self.elastic.current_mesh()
        if not self.elastic.is_alive():
            self.left = True
            return False
        if self._says():
            print(f"[FT] re-meshed (gen {self.elastic.generation}) over "
                  f"{len(self.elastic.alive)} ranks: "
                  f"{dict(self.mesh.sizes) if self.mesh else 'one device'}",
                  flush=True)
        return True

    def _one_step(self) -> float:
        toks, labs = self.pipeline.batch_at(self.step_idx)
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "labels": torch.from_numpy(labs).to(self.device)}
        t0 = time.perf_counter()
        if self.injector is not None:
            self.injector.maybe_fire(self.step_idx)
        self.state, metrics = self.cell.step(self.state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.metrics = {k: float(v) for k, v in metrics.items()}
        loss = self.metrics["loss"]
        slow = self.straggler.observe(self.step_idx, dt)
        self.monitor.beat(0)
        self.history.append({"step": self.step_idx, "loss": loss,
                             "seconds": dt, "straggler": slow})
        self.step_idx += 1
        return loss

    def run(self, n_steps: int, ckpt_every: int = 10,
            max_recoveries: int = 3, log_every: int = 10) -> list:
        """Steps until ``n_steps`` steps are done in all, committing a
        checkpoint every ``ckpt_every`` steps and at the end; a
        ``WorkerFailure`` or ``Preemption`` rebuilds the cell and resumes
        from the last committed step (a cold start without one), at most
        ``max_recoveries`` times; with ``elastic``, a ``WorkerFailure``
        re-meshes first, and a rank left out returns at once. Returns the
        history (re-run steps included)."""
        if self.state is None:
            self.init_state()
        while self.step_idx < n_steps:
            try:
                loss = self._one_step()
                if self._says() and (self.step_idx % log_every == 0
                                     or self.step_idx == n_steps):
                    print(f"step {self.step_idx:5d} loss {loss:.4f} "
                          f"{self.history[-1]['seconds']:.3f}s ewma "
                          f"{self.straggler.ewma:.3f}s", flush=True)
                if self.ckpt and self.step_idx % ckpt_every == 0:
                    self._save()
            except (WorkerFailure, Preemption) as e:
                self.recoveries += 1
                if self._says():
                    print(f"[FT] {e} at step {self.step_idx}; "
                          f"recovery {self.recoveries}/{max_recoveries}",
                          flush=True)
                if self.recoveries > max_recoveries:
                    raise
                self._settle()
                if isinstance(e, WorkerFailure):
                    self.monitor.mark_dead(e.worker)
                    if self.elastic is not None:
                        if not self._remesh(e.worker):
                            return self.history
                        self.state = None    # its blocks are the old mesh's
                self.cell = self._build_cell()
                if not self.restore_or_init():
                    print("[FT] no checkpoint found: cold restart",
                          flush=True)
        if self.ckpt:
            self._save()
            self.ckpt.wait()
        return self.history


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", default=None,
                    help="the arch's SMOKE config (default on the CPU)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the arch's published config (default on a card)")
    ap.add_argument("--shape", default="train_4k",
                    help="the LM train shape (its batch and seq are cut by "
                         "--batch and --seq)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="commit checkpoints here and resume from the "
                         "last committed one")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the published config, the CUDA kernels) or "
                         "cpu (the SMOKE config, the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    tr = Trainer(args.arch, smoke=args.smoke, shape=args.shape,
                 batch_override=args.batch, seq_override=args.seq,
                 seed=args.seed, device=args.device, ckpt_dir=args.ckpt_dir)
    cfg = tr.cfg
    print(f"{cfg.arch_id} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {cfg.microbatches} microbatches) on {tr.device}: "
          f"batch {tr.shape.batch} x seq {tr.shape.seq_len}", flush=True)
    if tr.restore_or_init():
        print(f"resumed from {args.ckpt_dir} at step {tr.step_idx}",
              flush=True)
    hist = tr.run(args.steps, ckpt_every=args.ckpt_every,
                  log_every=args.log_every)
    print(f"done: {len(hist)} steps, final loss {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
