"""gin-tu [gnn] — 5L d_hidden=64, sum aggregator, learnable eps
[arXiv:1810.00826]."""
from dataclasses import replace

from .base import GNNConfig

CONFIG = GNNConfig(
    arch_id="gin-tu", conv="gin", n_layers=5, d_hidden=64,
    aggregator="sum", eps_learnable=True,
)

SMOKE = replace(CONFIG, n_layers=2, d_hidden=16)
