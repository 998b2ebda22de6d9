"""Fault-tolerant LM training on the PyTorch/CUDA port: train
tinyllama-1.1b with periodic checkpoints, an INJECTED worker failure at
step 60, automatic rollback + resume, and straggler monitoring.

On a card the arch's published widths run (flash attention through
kernels 6, 7 and 8); ``--device cpu`` trains its SMOKE config on the
kernels' plain versions.

    PYTHONPATH=src python examples/torch_lm_train.py [--steps 200] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch.train import Trainer
from repro_torch.runtime.fault_tolerance import FaultInjector


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--fail-at", type=int, default=60)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        inj = FaultInjector.worker_failure_at(step=args.fail_at)
        tr = Trainer(args.arch, ckpt_dir=ckpt_dir, fault_injector=inj,
                     batch_override=args.batch, seq_override=args.seq,
                     device=args.device)
        tr.restore_or_init()
        hist = tr.run(args.steps, ckpt_every=args.ckpt_every,
                      log_every=args.ckpt_every)
        print(f"\ntrained {args.steps} steps on {tr.device} with "
              f"{tr.recoveries} recovery(ies); loss {hist[0]['loss']:.3f} "
              f"-> {hist[-1]['loss']:.3f}")
        flagged = [h["step"] for h in hist if h.get("straggler")]
        print(f"straggler steps flagged: {flagged if flagged else 'none'}")


if __name__ == "__main__":
    main()
