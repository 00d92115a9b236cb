"""``mea_attention`` (``kernels/mea_attention.cu``), either mode: the work
of the shapes it is launched at.  Operations: 4 dh a scored query-key
pair (2 for q k^T, 2 for p v, one sweep).  Bytes: q, k and v read and
the output written once, a (query row x head) row of dh values each, in
bf16.  The pairs and rows are those of the launched shapes (the
program's counters ``encoder.attn_<kind>_pairs`` and ``_rows``: B H L^2
pairs at the batch's bucket L, or B H times the band's pairs), padded
keys and padded query rows included, since the kernel is handed them
and scores them.  The kernel does more than this: two sweeps over the
keys, and in the window mode whole key tiles around the band
(``PERF.md``'s kernel table counts the two sweeps); a kernel that did
only this work would read 100%.  It is not the work the documents need:
in the long-document cell their own pairs (the sum of n^2, or of the
band's pairs at n, over the documents) are about 39% of the counted
global pairs and 54% of the local ones, so a kernel that skipped padded
tiles could pass this bound."""

from __future__ import annotations


def ops(pairs: int, dh: int) -> int:
    return 4 * dh * pairs


def nbytes(rows: int, dh: int, itemsize: int = 2) -> int:
    return 4 * rows * dh * itemsize


def bound_s(pairs: int, rows: int, dh: int, spec) -> float:
    """The least time the card could take: the larger of operations over
    its bf16 peak and bytes over its memory bandwidth."""
    return max(ops(pairs, dh) / spec["bf16"], nbytes(rows, dh) / spec["bytes"])
