"""Matmul FLOPs of a BERT-class encoder forward (``models/encoder.py``):
two per weight and token for the Dense layers (q, k, v, out, ffn_in,
ffn_out), and per layer and sequence of n real tokens 4 n^2 h for the
attention products (Q K^T and P V).  Embedding gathers, LayerNorms, the
softmax and pooling are left out (under 1% at these widths).  Counted
over the real tokens of each sequence, not its padded bucket."""

from __future__ import annotations

from typing import Iterable


def dense_weights(arch: dict) -> int:
    h, m = arch["hidden"], arch["mlp_dim"]
    return arch["num_layers"] * (4 * h * h + 2 * h * m)


def forward_flops(arch: dict, lengths: Iterable[int]) -> int:
    lengths = list(lengths)
    tokens = sum(lengths)
    sq = sum(n * n for n in lengths)
    return 2 * dense_weights(arch) * tokens + arch["num_layers"] * 4 * arch["hidden"] * sq
