"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 [hf:HuggingFaceTB/SmolLM]. 15 heads do not divide the 16-wide
model axis: attention-head sharding falls back to replication (fused qkv
dims 960 still shard); see DESIGN.md §3 divisibility fallback."""
from dataclasses import replace

from .base import LMConfig

CONFIG = LMConfig(
    arch_id="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, rope_theta=10_000.0,
    microbatches=4,
)

SMOKE = replace(CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
                d_ff=192, vocab=512, dtype="float32", remat=False)
