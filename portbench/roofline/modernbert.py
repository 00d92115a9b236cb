"""Matmul FLOPs of a ModernBERT forward (``models/modernbert.py``): two per
weight and token for the linear layers (``Wqkv``, ``Wo``, ``Wi`` and the
MLP's ``Wo``), and per sequence of n real tokens 4 n^2 h in each global
layer and 4 h x (the pairs |i - j| <= local_attention // 2 of [0, n)^2)
in each local layer for the attention products (Q K^T and P V).
Embedding gathers, norms, RoPE, the GLU product, the softmax and pooling
are left out (under 1% at these widths).  Counted over the real tokens of
each sequence, not its padded bucket.  ``cfg`` is the HF ``config.json``
dict."""

from __future__ import annotations

from typing import Iterable


def band_pairs(n: int, w: int) -> int:
    """The (i, j) pairs of [0, n)^2 with |i - j| <= w."""
    return n * n if w >= n - 1 else n * (2 * w + 1) - w * (w + 1)


def linear_weights(cfg: dict) -> int:
    h, m = cfg["hidden_size"], cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (4 * h * h + 3 * h * m)


def layer_kinds(cfg: dict) -> tuple:
    """(global layers, local layers): layers 0, k, 2k, ... are global."""
    n, k = cfg["num_hidden_layers"], cfg["global_attn_every_n_layers"]
    glob = (n + k - 1) // k
    return glob, n - glob


def forward_flops(cfg: dict, lengths: Iterable[int]) -> int:
    lengths = list(lengths)
    h, w = cfg["hidden_size"], cfg["local_attention"] // 2
    glob, local = layer_kinds(cfg)
    attn = sum(glob * n * n + local * band_pairs(n, w) for n in lengths)
    return 2 * linear_weights(cfg) * sum(lengths) + 4 * h * attn
