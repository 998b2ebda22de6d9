"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 [arXiv:2407.21783]."""
from dataclasses import replace

from .base import LMConfig

CONFIG = LMConfig(
    arch_id="llama3-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500_000.0,
    microbatches=4,
)

SMOKE = replace(CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                d_ff=256, vocab=512, dtype="float32", remat=False)
