"""Config dataclasses + shape tables for all assigned architectures.

Every architecture file in this package exports:
    CONFIG  — the exact published configuration (full scale)
    SMOKE   — a reduced same-family config for CPU smoke tests
Shapes are family-wide (the assignment pairs each arch family with its own
shape set); see SHAPES_* below.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

# --------------------------------------------------------------------- LM --

@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # expert-queue position: 'cumsum' = one-hot cumulative sum (baseline;
    # XLA lowers to an O(G²K²) reduce-window!) | 'sort' = argsort ranking
    # (§Perf iteration 1 — see EXPERIMENTS.md)
    dispatch: str = "cumsum"
    # dispatch locality: 'gather' = global-token-id gather/scatter (baseline;
    # SPMD must replicate the activations -> full all-gather + all-reduce per
    # layer) | 'shard_map' = EP-local dispatch (each model shard gathers its
    # own experts' tokens from its local activation replica; combine is one
    # [G_loc, D] psum) — §Perf iteration 2
    impl: str = "gather"


@dataclass(frozen=True)
class LMConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense FFN width, or expert width for MoE
    vocab: int
    moe: Optional[MoESpec] = None
    head_dim: Optional[int] = None
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # decode KV cache storage: 'auto' = activation dtype | 'int8' =
    # quantized cache + per-(token, kv-head) f32 scales (halves the decode
    # working set; quality validated in tests/test_kv_int8.py)
    kv_cache_dtype: str = "auto"
    remat: bool = True
    tie_embeddings: bool = False
    microbatches: int = 1          # gradient-accumulation microbatches
    family: str = "lm"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        D, F, V, H = self.d_model, self.d_ff, self.vocab, self.n_heads
        hd, KV, L = self.hd, self.n_kv_heads, self.n_layers
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.moe:
            ffn = self.moe.n_experts * 3 * D * F + D * self.moe.n_experts
        else:
            ffn = 3 * D * F
        per_layer = attn + ffn + 2 * D
        emb = V * D * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb + D

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only) — for 6ND."""
        if not self.moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        inactive = L * (self.moe.n_experts - self.moe.top_k) * 3 * D * F
        return self.param_count() - inactive


@dataclass(frozen=True)
class LMShape:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    batch: int


SHAPES_LM: Dict[str, LMShape] = {
    "train_4k":    LMShape("train_4k", "train", 4_096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  LMShape("decode_32k", "decode", 32_768, 128),
    # decode is O(seq), not O(seq^2): runnable for full-attention archs
    # (sequence-sharded KV cache) — see DESIGN.md §4.
    "long_500k":   LMShape("long_500k", "decode", 524_288, 1),
}

# -------------------------------------------------------------------- GNN --

@dataclass(frozen=True)
class GNNConfig:
    arch_id: str
    conv: str                      # gcn | sage | gatedgcn | gin
    n_layers: int
    d_hidden: int
    aggregator: str                # mean | sum | gated
    norm: str = "none"             # sym (GCN) | none
    sample_sizes: Tuple[int, ...] = ()
    eps_learnable: bool = False    # GIN
    dtype: str = "float32"
    remat: bool = False            # checkpoint each conv layer (deep GNNs)
    # segment-reduction combine: 'psum' (replicated output) or
    # 'reduce_scatter' (node-sharded output; ~half the collective bytes,
    # composes with the ('nodes', ...) constraint) — §Perf iteration
    comm: str = "psum"
    family: str = "gnn"


@dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str                      # full_graph | minibatch | dense_batch
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    batch_nodes: int = 0           # minibatch only
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 0          # dense_batch only
    nodes_per_graph: int = 0


SHAPES_GNN: Dict[str, GNNShape] = {
    "full_graph_sm": GNNShape("full_graph_sm", "full_graph",
                              2_708, 10_556, 1_433, 7),
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch",
                             232_965, 114_615_892, 602, 41,
                             batch_nodes=1_024, fanout=(15, 10)),
    "ogb_products": GNNShape("ogb_products", "full_graph",
                             2_449_029, 61_859_140, 100, 47),
    "molecule": GNNShape("molecule", "dense_batch", 30, 64, 16, 2,
                         batch_graphs=128, nodes_per_graph=30),
}

# ----------------------------------------------------------------- recsys --

@dataclass(frozen=True)
class RecsysConfig:
    arch_id: str
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    n_items: int = 8_388_608       # 2^23 rows (spec: 10^6-10^9)
    hist_len: int = 50
    n_negatives: int = 255          # sampled-softmax negatives per positive
    dtype: str = "float32"
    family: str = "recsys"


@dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str                      # train | serve | retrieval
    batch: int
    n_candidates: int = 0


SHAPES_RECSYS: Dict[str, RecsysShape] = {
    "train_batch":    RecsysShape("train_batch", "train", 65_536),
    "serve_p99":      RecsysShape("serve_p99", "serve", 512),
    "serve_bulk":     RecsysShape("serve_bulk", "serve", 262_144),
    "retrieval_cand": RecsysShape("retrieval_cand", "retrieval", 1,
                                  n_candidates=1_000_000),
}

# ---------------------------------------------------- ferrari (paper's own) --

@dataclass(frozen=True)
class FerrariServeConfig:
    arch_id: str = "ferrari-web"
    n_nodes: int = 16_777_216      # condensed web-graph scale (YAGO2-like)
    k_max: int = 8                 # interval slots per node (k=2..5 + G slack)
    seed_words: int = 1            # s = 32 seeds
    # index placement: 'replicated' (collective-free, whole table per chip)
    # | 'sharded' (rows over 'model': 16x memory-capacity scaling, queries
    # exchange ~104 B/query of masked-row psum — §Perf iteration F2)
    index_placement: str = "sharded"
    family: str = "ferrari"


@dataclass(frozen=True)
class FerrariShape:
    name: str
    kind: str                      # classify
    n_queries: int


SHAPES_FERRARI: Dict[str, FerrariShape] = {
    "classify_100k": FerrariShape("classify_100k", "classify", 100_000),
    "classify_16m":  FerrariShape("classify_16m", "classify", 16_777_216),
}


def shapes_for_family(family: str) -> Dict:
    return {"lm": SHAPES_LM, "gnn": SHAPES_GNN, "recsys": SHAPES_RECSYS,
            "ferrari": SHAPES_FERRARI}[family]
