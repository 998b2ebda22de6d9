"""gatedgcn [gnn] — 16L d_hidden=70, gated aggregator [arXiv:2003.00982]."""
from dataclasses import replace

from .base import GNNConfig

CONFIG = GNNConfig(
    arch_id="gatedgcn", conv="gatedgcn", n_layers=16, d_hidden=70,
    aggregator="gated", remat=True,   # 16 layers × per-edge gates: remat
)

SMOKE = replace(CONFIG, n_layers=3, d_hidden=16)
