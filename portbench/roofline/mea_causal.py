"""``mea_attention``'s causal mode (``kernels/mea_attention.cu``
``mea_causal_kernel``): the work of the live causal pairs it is handed.
Operations: 2 (d_qk + d_v) a live query-key pair j <= i of a head (2 d_qk
for q k^T, 2 d_v for p v, one sweep).  Bytes: q and k (d_qk each) and v
and the output (d_v each) read or written once, a (live query row x
head) row each, in bf16.  The pairs and rows are the program's counters
``encoder.attn_causal_pairs`` and ``encoder.attn_causal_rows``: the
documents' own pairs and rows, not the padded launch.  The kernel does
more than this (two sweeps over the keys, the diagonal tiles whole, the
tail of a document's last query tile), so a kernel that did only this
work would read 100%, and one that skipped padded tiles better than
today's cannot pass it."""

from __future__ import annotations


def ops(pairs: int, dqk: int, dv: int) -> int:
    return 2 * (dqk + dv) * pairs


def nbytes(rows: int, dqk: int, dv: int, itemsize: int = 2) -> int:
    return rows * (2 * dqk + 2 * dv) * itemsize


def bound_s(pairs: int, rows: int, dqk: int, dv: int, spec) -> float:
    """The least time the card could take: the larger of operations over
    its bf16 peak and bytes over its memory bandwidth."""
    return max(ops(pairs, dqk, dv) / spec["bf16"], nbytes(rows, dqk, dv) / spec["bytes"])
