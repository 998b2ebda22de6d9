"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]."""
from dataclasses import replace

from .base import LMConfig, MoESpec

CONFIG = LMConfig(
    arch_id="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, rope_theta=50_000.0,
    kv_cache_dtype="int8",
    moe=MoESpec(n_experts=64, top_k=6, dispatch="sort", impl="shard_map"), microbatches=4,
)

SMOKE = replace(CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                d_ff=64, vocab=512, dtype="float32", remat=False,
                moe=MoESpec(n_experts=8, top_k=2))
