"""graphsage-reddit [gnn] — 2L d_hidden=128, mean aggregator,
sample_sizes=25-10 [arXiv:1706.02216]."""
from dataclasses import replace

from .base import GNNConfig

CONFIG = GNNConfig(
    arch_id="graphsage-reddit", conv="sage", n_layers=2, d_hidden=128,
    aggregator="mean", sample_sizes=(25, 10),
)

SMOKE = replace(CONFIG, d_hidden=16, sample_sizes=(5, 3))
