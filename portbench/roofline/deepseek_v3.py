"""Matmul FLOPs of a DeepSeek-V3 embedder's forward
(``models/deepseek_v3.py``): two per active weight and real token, the
active weights of a layer being its attention projections (``q_proj``,
``kv_a``, ``kv_b``, ``o_proj``) and either its dense SwiGLU or its router,
``num_experts_per_tok`` routed experts and the shared experts; and for
the attention products 2 (d_qk + d_v) per head and live causal pair (the
n (n + 1) / 2 pairs j <= i of a document of n tokens) in each layer.
Embedding gathers, norms, RoPE, the SwiGLU product, the softmax, the
routing's sort and combine and the pooling are left out (under 1% at
these widths).  Counted over the real tokens of each document, not its
padded bucket.  ``cfg`` is the HF ``config.json`` dict."""

from __future__ import annotations

from typing import Iterable


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def attention_weights(cfg: dict) -> int:
    h, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    return h * H * (nope + rope) + h * (rank + rope) + rank * H * (nope + dv) + H * dv * h


def active_weights(cfg: dict) -> int:
    """The weights one token multiplies in a whole forward."""
    h, m = cfg["hidden_size"], cfg["moe_intermediate_size"]
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    expert = 3 * h * m
    per_moe = (cfg["n_routed_experts"] * h + cfg["num_experts_per_tok"] * expert
               + cfg["n_shared_experts"] * expert)
    return (cfg["num_hidden_layers"] * attention_weights(cfg)
            + dense * 3 * h * cfg["intermediate_size"] + moe * per_moe)


def forward_flops(cfg: dict, lengths: Iterable[int]) -> int:
    lengths = list(lengths)
    per_pair = 2 * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])
    attn = cfg["num_hidden_layers"] * cfg["num_attention_heads"] * per_pair * \
        sum(causal_pairs(n) for n in lengths)
    return 2 * active_weights(cfg) * sum(lengths) + attn
