"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 [arXiv:2401.02385]."""
from dataclasses import replace

from .base import LMConfig

CONFIG = LMConfig(
    arch_id="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000, rope_theta=10_000.0,
    microbatches=4,
)

SMOKE = replace(CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                d_ff=256, vocab=512, dtype="float32", remat=False)
