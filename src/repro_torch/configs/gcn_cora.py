"""gcn-cora [gnn] — 2L d_hidden=16, mean aggregator, symmetric norm
[arXiv:1609.02907]."""
from dataclasses import replace

from .base import GNNConfig

CONFIG = GNNConfig(
    arch_id="gcn-cora", conv="gcn", n_layers=2, d_hidden=16,
    aggregator="mean", norm="sym",
)

SMOKE = replace(CONFIG, d_hidden=8)
