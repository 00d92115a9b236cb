"""``binmax_int8``: pass 1 of the int8 two-pass search.  Each of Q int8
queries (with one f32 scale each) is scored against every one of ``cap``
int8 rows (one f32 scale each), and the maximum of every bin of
``bin_width`` rows is written as f32.

Bytes count each input byte once and each output byte once, whatever
the kernel reads again: rows, row scales, queries, query scales, the
(Q, cap / bin_width) output.  Operations: one multiply and one add per
row, query and dimension."""

from __future__ import annotations


def nbytes(cap: int, Q: int, d: int, bin_width: int) -> int:
    return cap * d + cap * 4 + Q * d + Q * 4 + Q * (cap // bin_width) * 4


def ops(cap: int, Q: int, d: int) -> int:
    return 2 * cap * Q * d


def bound_s(cap: int, Q: int, d: int, bin_width: int, spec) -> float:
    """The least time the card could take: the larger of bytes over its
    memory bandwidth and operations over its int8 peak."""
    return max(nbytes(cap, Q, d, bin_width) / spec["bytes"], ops(cap, Q, d) / spec["int8"])
