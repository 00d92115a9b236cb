"""Matmul FLOPs of one contrastive training step (``models/train.py``):
the forward of every query and positive, and the backward at twice the
forward (6 per Dense weight and token; 3 x 4 n^2 h per layer and
sequence for attention).  The B x B logits and the optimizer's
elementwise work are left out (under 1%)."""

from __future__ import annotations

from typing import Iterable

from portbench.roofline.encoder import dense_weights


def step_flops(arch: dict, lengths: Iterable[int]) -> int:
    """Over the real tokens of the step's 2 x batch sequences."""
    lengths = list(lengths)
    tokens = sum(lengths)
    sq = sum(n * n for n in lengths)
    return 6 * dense_weights(arch) * tokens + 3 * arch["num_layers"] * 4 * arch["hidden"] * sq


def padded_step_flops(arch: dict, batch: int, seq_len: int) -> int:
    """The same at the padded shapes the trainer runs: 2 x ``batch``
    sequences of ``seq_len`` positions."""
    return step_flops(arch, [seq_len] * (2 * batch))
