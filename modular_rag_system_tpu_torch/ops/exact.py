"""Exact f32 top-k search and the in-place row writes of the index.

The exact tier scores in true f32: TF32 must be off on the card
(``utils.device.resolve_device`` turns it off for every CUDA entry
point).  Ties go to the lowest row id, which ``torch.topk`` does not
promise, so the top-k is a stable descending sort.
"""

from __future__ import annotations

import torch


def stable_topk(scores: torch.Tensor, k: int):
    """Top-k along dim 1, values descending, ties by lowest position (the
    order of the JAX package's ``lax.top_k`` and ``_topk_positional``)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def exact_topk_raw(E: torch.Tensor, count: int, q: torch.Tensor, k: int):
    """Top-k inner-product search over the live prefix of E.

    E (capacity, d) f32 or bf16, q (Q, d) f32 -> (scores (Q, k) f32,
    rows (Q, k) int32); rows at or past ``count`` score -inf."""
    scores = q.float() @ E.float().T
    col = torch.arange(E.shape[0], device=E.device)
    scores = torch.where(col[None, :] < count, scores, float("-inf"))
    vals, rows = stable_topk(scores, k)
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
