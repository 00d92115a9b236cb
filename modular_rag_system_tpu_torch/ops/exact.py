"""Exact f32 top-k search and the in-place row writes of the index.

The exact tier scores in true f32: TF32 must be off on the card
(``utils.device.resolve_device`` turns it off for every CUDA entry
point).  Ties go to the lowest row id, which ``torch.topk`` does not
promise, so the top-k is a stable descending sort, taken per row block
so that no (Q, capacity) buffer is ever held.
"""

from __future__ import annotations

from typing import Optional

import torch


def stable_topk(scores: torch.Tensor, k: int):
    """Top-k along dim 1, values descending, ties by lowest position (the
    order of the JAX package's ``lax.top_k`` and ``_topk_positional``)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


# f32 bytes of one block of the exact top-k: its (Q, B) scores, plus its
# f32 upcast of B rows over a bf16 master.  The block's stable sort holds
# about 12 times its scores at its peak (values, int64 positions and the
# sort's scratch: 806 MB for 64 MiB of scores on an H100), so a block
# needs about 3 GiB of device memory at any Q.
_EXACT_BLOCK_BYTES = 1 << 28


def exact_block_rows(Q: int, d: int, upcast: bool, k: int) -> int:
    """Rows B of one block of ``exact_topk_raw``: its scores (and, over a
    bf16 master, its f32 rows) within ``_EXACT_BLOCK_BYTES``, never fewer
    than k rows."""
    per_row = 4 * max(Q, 1) + (4 * d if upcast else 0)
    return max(k, _EXACT_BLOCK_BYTES // per_row, 1)


def exact_topk_raw(E: torch.Tensor, count: int, q: torch.Tensor, k: int,
                   block_rows: Optional[int] = None):
    """Top-k inner-product search over the live prefix of E.

    E (capacity, d) f32 or bf16, q (Q, d) f32 -> (scores (Q, k) f32,
    rows (Q, k) int32); where count < k the last slots are -inf with the
    row ids count, count + 1, ... (``lax.top_k``'s order over the masked
    columns).

    The live prefix is walked in blocks of ``block_rows`` rows (default
    ``exact_block_rows``): each block's stable top-k is merged into a
    running (Q, k) by one stable descending sort of [running, block].
    Running entries have lower row ids than the block's, so ties keep
    the lowest row id first.  Transient memory is O(Q (B + 2k)), never a
    (Q, capacity) buffer; rows at or past ``count`` are never scored."""
    Q, d = q.shape[0], E.shape[1]
    count = max(0, min(int(count), E.shape[0]))
    upcast = E.dtype != torch.float32
    B = block_rows or exact_block_rows(Q, d, upcast, k)
    qf = q.float()
    vals = torch.empty((Q, 0), dtype=torch.float32, device=E.device)
    rows = torch.empty((Q, 0), dtype=torch.int64, device=E.device)
    for s in range(0, count, B):
        sc = qf @ E[s:min(s + B, count)].float().T
        bv, bp = stable_topk(sc, k)
        del sc
        vals, pos = stable_topk(torch.cat([vals, bv], dim=1), k)
        rows = torch.gather(torch.cat([rows, bp + s], dim=1), 1, pos)
    if vals.shape[1] < k:  # fewer live rows than k: the masked columns
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        fill = torch.arange(count, count + pad, device=E.device).expand(Q, pad)
        rows = torch.cat([rows, fill], dim=1)
    return vals, rows.to(torch.int32)


def append_rows(E: torch.Tensor, batch: torch.Tensor, start: int) -> None:
    """Write ``batch`` into E from row ``start`` (in place)."""
    E[start : start + batch.shape[0]] = batch.to(E.dtype)


def set_rows(E: torch.Tensor, rows: torch.Tensor, mat: torch.Tensor) -> None:
    """Overwrite specific rows (in place)."""
    E[rows] = mat.to(E.dtype)


def zero_rows(E: torch.Tensor, rows: torch.Tensor) -> None:
    """Zero deleted rows (in place): they score 0 and the document store's
    tombstones filter them on the host."""
    E[rows] = 0
