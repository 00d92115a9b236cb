"""The roofline and mfu arithmetic reproduces PERF.md's bounds from
their shapes.  The mfu metrics count real tokens instead of the padded
shapes these bounds use."""

from __future__ import annotations

import pytest

from portbench.common import SPECS
from portbench.reference.bert import bundled_arch
from portbench.roofline import binmax_int8, encoder, train_step

H100 = SPECS["H100"]


def test_binmax_int8_bound_at_the_two_pass_route():
    # 1,048,576 int8 rows of 768, Q = 256, bins of 32 rows
    cap, Q, d, bw = 1_048_576, 256, 768, 32
    assert binmax_int8.nbytes(cap, Q, d, bw) == 843_252_736
    assert binmax_int8.bound_s(cap, Q, d, bw, H100) * 1e3 == pytest.approx(0.2517, abs=5e-5)
    # bytes bound it: the int8 operations take a seventh of that
    assert binmax_int8.ops(cap, Q, d) / H100["int8"] < binmax_int8.nbytes(cap, Q, d, bw) / H100["bytes"]


def test_trainer_bound_at_padded_shapes():
    arch = bundled_arch()
    flops = train_step.padded_step_flops(arch, 256, 128)
    assert flops == 2_937_757_630_464
    assert flops / H100["bf16"] * 1e3 == pytest.approx(2.970, abs=5e-4)


def test_real_tokens_count_less_than_padding():
    arch = bundled_arch()
    lengths = [14, 55] * 256  # a question and a passage a pair
    assert train_step.step_flops(arch, lengths) < train_step.padded_step_flops(arch, 256, 128) / 2
    assert encoder.forward_flops(arch, [10]) == 2 * encoder.dense_weights(arch) * 10 + 4 * 4 * 384 * 100

