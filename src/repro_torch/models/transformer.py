"""Decoder-only LM (llama family), dense variant: GQA, RoPE, SwiGLU FFN.

Layer parameters are stacked on a leading ``layers`` axis with the
reference's names and layouts (``wq [L, D, H·hd]``, ``w_gate [L, D, F]``,
…); the layer loop is a Python loop over ``params["layers"][name][i]``
(or over a list of per-layer dicts: ``layer_leaves``). Prefill and
training run flash attention (kernel 6 on a card, kernels 7 and 8 in the
backward) once per layer through ``chunked_attention``; decode runs the
plain masked softmax over the cache. ``logits_and_loss`` is the training
loss, a chunked and checkpointed cross-entropy; with ``cfg.remat`` the
forward recomputes each layer in the backward. Unlike the reference there
is no mesh and no sharding: a model runs on one device. The MoE FFN and
the int8 KV cache (the two MoE configs) are not ported (ROADMAP.md, Queue
1 item 8).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from .attention import chunked_attention, decode_attention
from .common import normal_init, rms_norm, rope_tables, rotate

LAYER_LEAVES = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate",
                "w_up", "w_down")


def dense_only(cfg: LMConfig) -> None:
    if cfg.moe is not None or cfg.kv_cache_dtype != "auto":
        raise NotImplementedError(
            f"{cfg.arch_id}: the MoE FFN and the int8 KV cache are not "
            f"ported to repro_torch yet (ROADMAP.md, Queue 1 item 8)")


def init_params(cfg: LMConfig, gen: torch.Generator, device):
    """The reference's params tree with its scales, drawn from ``gen`` (a
    generator on ``device``): norms at 1, projections N(0, 1)·fan_in^-1/2,
    the embedding N(0, 1)."""
    dense_only(cfg)
    dt = getattr(torch, cfg.dtype)
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    s_in = D ** -0.5

    def normal(shape, scale):
        return normal_init(gen, shape, scale, dt, device)

    lay = {
        "attn_norm": torch.ones((L, D), dtype=dt, device=device),
        "mlp_norm": torch.ones((L, D), dtype=dt, device=device),
        "wq": normal((L, D, H * hd), s_in),
        "wk": normal((L, D, KV * hd), s_in),
        "wv": normal((L, D, KV * hd), s_in),
        "wo": normal((L, H * hd, D), (H * hd) ** -0.5),
        "w_gate": normal((L, D, F_), s_in),
        "w_up": normal((L, D, F_), s_in),
        "w_down": normal((L, F_, D), F_ ** -0.5),
    }
    params = {"embed": normal((V, D), 1.0),
              "final_norm": torch.ones((D,), dtype=dt, device=device),
              "layers": lay}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), s_in)
    return params


def _layer_params(params, i: int) -> dict:
    layers = params["layers"]
    if isinstance(layers, list):                 # per-layer leaves
        return layers[i]
    return {name: layers[name][i] for name in LAYER_LEAVES}


def layer_leaves(params) -> dict:
    """``params`` with its stacked layer leaves split into a list of
    per-layer dicts of views, each view a fresh autograd leaf, as is every
    other leaf. Differentiating with respect to them gives each layer's
    gradient by itself: the autograd of ``stacked[i]`` would instead write
    a zero-filled gradient of the whole stack for every layer and leaf."""
    def leaf(t):
        return t.detach().requires_grad_()
    out = {name: leaf(t) for name, t in params.items() if name != "layers"}
    n = params["layers"][LAYER_LEAVES[0]].shape[0]
    out["layers"] = [{name: leaf(params["layers"][name][i])
                      for name in LAYER_LEAVES} for i in range(n)]
    return out


def _head(cfg: LMConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _dense_ffn(lp, x):
    h = F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])
    return h @ lp["w_down"]


def _qkv(cfg: LMConfig, lp, x, cos, sin):
    """Normed, projected and rotated q [B, S, H, hd], k, v [B, S, KV, hd]."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, H, hd)
    k = (h @ lp["wk"]).reshape(B, S, KV, hd)
    v = (h @ lp["wv"]).reshape(B, S, KV, hd)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _finish_layer(cfg: LMConfig, lp, x, att):
    """Output projection, residual, FFN, residual."""
    B, S = x.shape[:2]
    x = x + att.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["wo"]
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _dense_ffn(lp, h2)


def _layer(cfg: LMConfig, lp, x, cos, sin):
    """One layer over a prompt: (new x, its k and v [B, S, KV, hd])."""
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    att = chunked_attention(q, k, v, causal=True)
    return _finish_layer(cfg, lp, x, att), k, v


def _positions(B: int, S: int, device, start: int = 0):
    return (start + torch.arange(S, dtype=torch.int32, device=device)
            ).expand(B, S)


def _layer_out(cfg: LMConfig, lp, x, cos, sin):
    return _layer(cfg, lp, x, cos, sin)[0]


def forward(cfg: LMConfig, params, tokens):
    """tokens [B, S] → final hidden states [B, S, D]. With ``cfg.remat``
    each layer is checkpointed (the reference's ``jax.checkpoint`` of its
    scanned body): the backward recomputes it from its input."""
    dense_only(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    cos, sin = rope_tables(_positions(B, S, tokens.device), cfg.hd,
                           cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if cfg.remat:
            x = checkpoint(_layer_out, cfg, lp, x, cos, sin,
                           use_reentrant=False)
        else:
            x = _layer_out(cfg, lp, x, cos, sin)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _chunk_loss(h, head, labels, weight):
    """Σ weight · (logsumexp − the label's logit) over one chunk of rows;
    the product rounds to the params' dtype before the float32 softmax,
    as the reference's einsum does."""
    logits = (h @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.sum((lse - ll) * weight)


def logits_and_loss(cfg: LMConfig, params, tokens, labels,
                    loss_chunk=16384):
    """Mean next-token cross-entropy of ``tokens [B, S]`` against ``labels
    [B, S]``, float32. The [B·S, V] logits are produced and reduced chunk
    by chunk (rows padded to a multiple of ``loss_chunk`` with weight 0),
    each chunk checkpointed so that the backward recomputes its [chunk, V]
    logits instead of keeping them. ``loss_chunk=None``: one chunk."""
    hs = forward(cfg, params, tokens)
    B, S, D = hs.shape
    G = B * S
    chunk = min(loss_chunk or G, G)
    nc = -(-G // chunk)
    pad = nc * chunk - G
    hf = F.pad(hs.reshape(G, D), (0, 0, 0, pad))
    lf = F.pad(labels.reshape(G).long(), (0, pad))
    wmask = F.pad(torch.ones(G, dtype=torch.float32, device=hs.device),
                  (0, pad))
    head = _head(cfg, params)
    total = torch.zeros((), dtype=torch.float32, device=hs.device)
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, hf[rows], head, lf[rows],
                                   wmask[rows], use_reentrant=False)
    return total / G


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device):
    """KV cache ``{"k", "v"}`` of zeros [L, B, max_seq, KV, hd] in the
    model's dtype."""
    dense_only(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _logits(cfg: LMConfig, params, x):
    """[B, 1, D] → float32 logits [B, V]."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _head(cfg, params))[:, 0].float()


def prefill(cfg: LMConfig, params, tokens, max_seq: int):
    """Process a full prompt tokens [B, S]: (last-token logits [B, V]
    float32, cache with the prompt's keys and values in positions < S)."""
    dense_only(cfg)
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    x = params["embed"][tokens.long()]
    cos, sin = rope_tables(_positions(B, S, tokens.device), cfg.hd,
                           cfg.rope_theta)
    cache = init_cache(cfg, B, max_seq, tokens.device)
    for i in range(cfg.n_layers):
        x, k, v = _layer(cfg, _layer_params(params, i), x, cos, sin)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: LMConfig, params, cache, token, pos):
    """One decode step. token [B, 1] int; pos: int (or a 0-d tensor), the
    position being decoded. Returns (logits [B, V] float32, cache).

    The cache is updated IN PLACE (this token's keys and values written at
    ``pos`` in every layer) and returned, where the reference returns a
    new one: a copy of a 32k-token cache per token would double the
    decode's memory traffic."""
    dense_only(cfg)
    pos = int(pos)
    B = token.shape[0]
    x = params["embed"][token.long()]                       # [B, 1, D]
    cos, sin = rope_tables(_positions(B, 1, token.device, pos), cfg.hd,
                           cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = v[:, 0]
        att = decode_attention(q, cache["k"][i], cache["v"][i], pos)
        x = _finish_layer(cfg, lp, x, att)
    return _logits(cfg, params, x), cache
