"""GPipe-style pipeline parallelism over a mesh axis (the reference's
optional PP mode over 'pod').

Each stage rank along ``axis`` holds one stage's params; the global
batch splits into ``microbatches`` chunks that stream through the stages
in the GPipe fill-drain schedule: at tick t stage s runs microbatch
t − s, over M + S − 1 ticks (bubble fraction (S − 1) / (M + S − 1)).
The reference hands each stage's output on with ``jax.lax.ppermute``
inside ``shard_map`` on every tick; here stage s receives its input from
stage s − 1 and sends its output to stage s + 1 (``send`` / ``recv``
within the axis's process group), only on the ticks that carry a
microbatch, and the last stage's outputs are broadcast to every stage,
as the reference's psum leaves them on every device. gloo moves host
memory only, so over a gloo group a CUDA activation is staged through
the host for its send and receive.

Forward only, as the reference's own test holds it: no path of the
reference differentiates the pipeline (its dry-run only compiles it),
so its backward is outside the reference and not ported (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import _count


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _send(t: torch.Tensor, dst: int, group) -> None:
    t = t.contiguous()
    dist.send(t.cpu() if _via_host(t, group) else t, dst=dst, group=group)
    _count("pipeline_send", t, "collective-permute")


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = torch.empty_like(like, device="cpu") if _via_host(like, group) \
        else torch.empty_like(like)
    dist.recv(buf, src=src, group=group)
    _count("pipeline_recv", buf, "collective-permute")
    return buf.to(like.device)


def pipeline_forward(mesh, stage_fn: Callable, n_stages: int,
                     microbatches: int, axis: str = "pod"):
    """Build fn(stage_params, x) running ``stage_fn(params_i, x)`` per
    stage over ``mesh`` (a ``launch.mesh.Mesh``).

    stage_params: this rank's block of a tree of leaves with a leading
    [n_stages] axis split over ``axis`` (leading dim 1: its stage's).
    x: [B, ...] the whole batch, on every rank, split into
    ``microbatches`` chunks; ``stage_fn`` keeps a chunk's shape, as the
    reference's carry does. Returns the last stage's output [B, ...] on
    every rank of ``axis``."""
    if mesh.sizes[axis] != n_stages:
        raise ValueError(f"{n_stages} stages over a {axis!r} axis of "
                         f"{mesh.sizes[axis]}")
    group = mesh.group(axis)
    ranks = mesh.members(axis)            # global ranks, stage order
    stage = mesh.index(axis)

    def fn(stage_params, x):
        params = _tree_first(stage_params)
        mb = torch.chunk(x, microbatches, dim=0)
        outs = []
        for t in range(microbatches + n_stages - 1):
            i = t - stage                     # this stage's microbatch
            if not 0 <= i < microbatches:
                continue
            inp = mb[i] if stage == 0 else _recv(mb[i], ranks[stage - 1],
                                                 group)
            y = stage_fn(params, inp)
            if stage < n_stages - 1:
                _send(y, ranks[stage + 1], group)
            else:
                outs.append(y)
        out = (torch.cat(outs, dim=0) if outs
               else torch.empty_like(x))
        if group is not None:
            dist.broadcast(out, src=ranks[-1], group=group)
            _count("pipeline_broadcast", out, "broadcast")
        return out

    return fn


def _tree_first(tree):
    """Each leaf's block at leading index 0 (this stage's params)."""
    if isinstance(tree, dict):
        return {k: _tree_first(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_first(v) for v in tree]
    return tree[0]


def demo_stage_fn(params, x):
    """Toy two-matmul stage for tests."""
    return torch.tanh(x @ params["w"]) @ params["w2"]
