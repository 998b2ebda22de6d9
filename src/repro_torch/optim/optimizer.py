"""AdamW, its learning-rate schedules and global-norm clipping over nested
dicts of tensors (the counterpart of the reference's ``optim/
optimizer.py``).

The moments m and v are float32 whatever the parameter dtype. Weight decay
applies to the leaves with ``ndim >= 2``; the LM's layer leaves are stacked
``[L, …]``, so its norms ``[L, D]`` are decayed, as in the reference.

Unlike the reference, ``adamw_update`` updates the params, m and v IN
PLACE and returns them (a copy of tinyllama-1.1b's 13 GB of params and
moments per step would only move bytes), and ``clip_by_global_norm``
scales the gradients in place. The step count is an int32 0-d tensor on
the host: the schedule and the bias corrections are scalars, taken in
float32 as the reference takes them, with no device sync.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # cosine | constant | linear


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


def _leaves(tree) -> list:
    """The leaves in sorted-key order (as ``jax.tree.leaves``), so that
    trees built in different orders line up."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {key: _map(fn, value) for key, value in tree.items()}
    return fn(tree)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a float32
    0-d tensor on the host: linear warm-up, then cosine, constant or
    linear decay to ``total_steps``."""
    step = _f32(step.cpu() if isinstance(step, torch.Tensor) else step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        decay = _f32(1.0)
    elif cfg.schedule == "linear":
        decay = torch.clamp(1.0 - (step - cfg.warmup_steps) / span, min=0.0)
    else:  # cosine
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
    return cfg.lr * warm * decay


def adamw_init(params) -> dict:
    """Zero m and v (float32, on each param's device) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient, in place, by min(1, max_norm / (norm + 1e-9))
    cast to its dtype, where norm is the float32 L2 norm over every leaf.
    Returns (grads, norm as a float32 0-d tensor on the grads' device)."""
    leaves = _leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


def adamw_update(cfg: OptConfig, params, grads, opt_state):
    """One AdamW step, in place on ``params`` and ``opt_state`` (and on
    ``grads``, which are clipped). Returns (params, opt_state, metrics
    {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt_state["step"] + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1.0 - _f32(b1) ** step.float())
    bc2 = float(1.0 - _f32(b2) ** step.float())
    lr_f = float(lr)
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(opt_state["m"]), _leaves(opt_state["v"])):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and p.ndim >= 2:   # no decay on 1-d leaves
            delta.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta, alpha=lr_f)
        else:
            p.copy_(p.float().sub_(delta, alpha=lr_f))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
