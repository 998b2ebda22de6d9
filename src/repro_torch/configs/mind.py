"""mind [recsys] — embed_dim=64 n_interests=4 capsule_iters=3,
multi-interest interaction [arXiv:1904.08030]. Item table 2^23 rows
(spec range 10^6-10^9), row-sharded over the model axis."""
from dataclasses import replace

from .base import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="mind", embed_dim=64, n_interests=4, capsule_iters=3,
    n_items=8_388_608, hist_len=50, n_negatives=255,
)

SMOKE = replace(CONFIG, n_items=1_024, hist_len=10, n_negatives=15)
