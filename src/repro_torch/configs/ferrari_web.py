"""ferrari-web — the paper's own system as a servable architecture.

Phase-1 batched reachability classification over a web-scale packed index
(16.7M condensed nodes ≈ YAGO2). serve_step = fused interval-stab classify;
the UNKNOWN residue goes to guided search (host / phase-2) per DESIGN.md."""
from dataclasses import replace

from .base import FerrariServeConfig

CONFIG = FerrariServeConfig(
    arch_id="ferrari-web", n_nodes=16_777_216, k_max=8, seed_words=1,
)

SMOKE = replace(CONFIG, n_nodes=4_096, k_max=4)
