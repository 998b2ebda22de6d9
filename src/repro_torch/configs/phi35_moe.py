"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from dataclasses import replace

from .base import LMConfig, MoESpec

CONFIG = LMConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, rope_theta=10_000.0,
    kv_cache_dtype="int8",
    moe=MoESpec(n_experts=16, top_k=2, dispatch="sort", impl="shard_map"), microbatches=4,
)

SMOKE = replace(CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=512, dtype="float32", remat=False,
                moe=MoESpec(n_experts=4, top_k=2))
