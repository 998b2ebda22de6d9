"""Shared model building blocks."""
from __future__ import annotations

import torch


def normal_init(gen: torch.Generator, shape, scale, dtype, device):
    """``scale · N(0, 1)`` drawn in float32 from ``gen`` on ``device`` (the
    generator must live there), then cast to ``dtype``."""
    z = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (scale * z).to(dtype)
