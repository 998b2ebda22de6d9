"""Shared model building blocks."""
from __future__ import annotations

import torch


def normal_init(gen: torch.Generator, shape, scale, dtype, device):
    """``scale · N(0, 1)`` drawn in float32 from ``gen`` on ``device`` (the
    generator must live there), then cast to ``dtype``."""
    z = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (scale * z).to(dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    """RMS normalisation over the last axis, in float32, cast back to x's
    dtype."""
    x32 = x.float()
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    return (y * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    """[hd/2] float32 inverse frequencies. Taken in float64 and rounded
    once, so the card and the CPU get the same values."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float64, device=device) / half
    return (1.0 / theta ** exps).float()


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) [..., S, 1, hd/2] float32 of ``positions [..., S]``: the
    rotation that ``rotate`` applies; a model takes them once per call and
    shares them between its layers."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., :, None].float() * inv
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def rotate(x, cos, sin):
    """x [..., S, H, hd] rotated by ``rope_tables``, in float32, cast back to
    x's dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] int."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def cross_entropy(logits, labels):
    """Stable CE in float32; logits [..., V], labels [...] int. Returns
    the mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
