"""Single-pass top-k: the ``fused_topk_int8`` and ``fused_topk`` CUDA
kernels, their plain PyTorch versions, and the selection helpers.

``fused_topk_int8_raw`` computes, per query, the top-k of
``(bf16(q) . float(E_q[r])) * scale[r]`` over rows ``r < count``;
``fused_topk_raw`` the top-k of ``bf16(q) . bf16(E[r])`` over f32 or
bf16 rows, summed in f32 (the TPU kernel's default-precision products,
the fused/bf16 tiers' similarity contract).  Both launch one kernel
template (``kernels/fused_topk.cu``) over the row type, with one launch
plan (``fused_topk_plan``) that takes a row value's bytes.  Both order
by (score desc, row id asc), with the optional per-bin candidate
reduction of the TPU kernels (``_bin_reduce``).  A wrapper launches its kernel for tensors on a CUDA
device and runs its plain version for tensors on the CPU.  Scores agree
up to f32 summation order; slots left at -inf carry arbitrary ids.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from modular_rag_system_tpu_torch import kernels
from modular_rag_system_tpu_torch.ops.exact import stable_topk

_NEG_INF = float("-inf")
_BIG_I32 = 2**31 - 1
_KERNEL_MAX_K = 8192


def _select_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of (Q, n) candidates by (value desc, id asc) -> (vals, ids)."""
    order = torch.argsort(ids, dim=1, stable=True)
    s = torch.gather(scores, 1, order)
    vals, pos = stable_topk(s, k)
    return vals, torch.gather(torch.gather(ids, 1, order), 1, pos).to(torch.int32)


def _bin_reduce(scores: torch.Tensor, gids: torch.Tensor, bin_width: Optional[int]):
    """Per-bin candidate reduction: the max of each ``bin_width`` run of
    scores, with the lowest id among the tied maxima.  None = identity."""
    if bin_width is None:
        return scores, gids
    Q, B = scores.shape
    s3 = scores.view(Q, B // bin_width, bin_width)
    cand = s3.amax(dim=2)
    g3 = gids.view(Q, B // bin_width, bin_width)
    cand_ids = torch.where(s3 == cand[:, :, None], g3, _BIG_I32).amin(dim=2)
    return cand, cand_ids


def _check_bin_width(bin_width: Optional[int], block_rows: int) -> None:
    """The TPU kernels' bin reduction needs bins that are a multiple of
    128 lanes and tile ``block_rows``; the port keeps the same rule."""
    if bin_width is None:
        return
    if bin_width % 128 or block_rows % bin_width:
        raise ValueError(
            f"bin_width must be a multiple of 128 dividing block_rows "
            f"({block_rows}); got {bin_width}")


def _topk_of_scores(scores, count: int, k: int, bin_width: Optional[int]):
    """The plain versions' tail: mask rows >= count, bin-reduce, pad to
    k candidates, stable selection by (score desc, id asc)."""
    Q, cap = scores.shape
    gids = torch.arange(cap, device=scores.device, dtype=torch.int32)
    gids = gids[None, :].expand(Q, cap)
    scores = torch.where(gids < count, scores, _NEG_INF)
    scores, gids = _bin_reduce(scores, gids.contiguous(), bin_width)
    if scores.shape[1] < k:  # fewer candidates than k: empty slots
        pad = k - scores.shape[1]
        scores = torch.nn.functional.pad(scores, (0, pad), value=_NEG_INF)
        gids = torch.nn.functional.pad(gids, (0, pad), value=_BIG_I32)
    return _select_topk(scores, gids, k)


def fused_topk_int8_reference(E_q, scales, count: int, q, k: int,
                              bin_width: Optional[int] = None):
    """Plain PyTorch version of the kernel: the whole (Q, cap) score
    matrix, masked, bin-reduced, then a stable selection."""
    qb = q.to(torch.bfloat16).float()
    scores = (qb @ E_q.float().T) * scales.reshape(1, -1)
    return _topk_of_scores(scores, count, k, bin_width)


def fused_topk_reference(E, count: int, q, k: int, bin_width: Optional[int] = None):
    """Plain PyTorch version of ``fused_topk``: q and the rows rounded
    to bf16, exact products summed in f32 (TF32 is off on the card)."""
    qb = q.to(torch.bfloat16).float()
    scores = qb @ E.to(torch.bfloat16).float().T
    return _topk_of_scores(scores, count, k, bin_width)


# launch configurations of the fused_topk kernel (kernels/fused_topk.cu
# ``dispatch``): (query columns of the tensor-core tile, ring stages)
_FUSED_CFGS = ((8, 6), (8, 2), (32, 6))
_FUSED_CHUNK = 128       # rows a CTA scores at a time
_FUSED_BK = 32           # depth of a k-step
_FUSED_TARGET_CTAS = 132  # one CTA per SM of an H100
_FUSED_MERGE_KEYS = 16384  # S x k keys of one query's merge
# the widest row: the kernel walks d in 32-deep k-steps and holds a query
# tile of d values (the plan narrows the tile where it does not fit)
_FUSED_MAX_D = 2048


def fused_topk_keys(k: int):
    """(KP, T): a query's best-key slots (the next power of two >= k) and
    its whole key buffer: up to 32 keys the kernel selects by warp
    minima and keeps no candidates; above, room for one chunk of
    candidates beside them."""
    kp = 1 << (k - 1).bit_length()
    if kp <= 32:
        return kp, kp
    return kp, (2 * kp if kp >= _FUSED_CHUNK else 2 * _FUSED_CHUNK)


def _ring_row_bytes(row_bytes: int) -> int:
    """Bytes of one staged row of a k-step: f32 and bf16 rows padded by 8
    values, int8 rows by 16 bytes (so their 16-byte copies stay aligned)."""
    if row_bytes not in (1, 2, 4):
        raise ValueError(f"row_bytes must be 1 (int8), 2 (bf16) or 4 (f32); got {row_bytes}")
    return _FUSED_BK + 16 if row_bytes == 1 else (_FUSED_BK + 8) * row_bytes


def fused_topk_smem(cfg: int, d: int, row_bytes: int, qb: int, k: int) -> int:
    """Shared-memory bytes of a ``fused_topk`` CTA over rows of
    ``row_bytes``-byte values (4 f32, 2 bf16, 1 int8): the row ring, the
    query tile (bf16, rows padded by 16 bytes), the score tile, the key
    buffers of ``qb`` queries and the per-query carry and count."""
    qt, stages = _FUSED_CFGS[cfg]
    dpad = -(-d // _FUSED_BK) * _FUSED_BK
    ring = stages * _FUSED_CHUNK * _ring_row_bytes(row_bytes)
    _, T = fused_topk_keys(k)
    return (ring + qt * (dpad + 8) * 2 + qt * (_FUSED_CHUNK + 4) * 4 + qb * T * 8
            + qt * 8 + qt * 4)


@functools.lru_cache(maxsize=1024)
def fused_topk_plan(Q: int, k: int, count: int, d: int, row_bytes: int,
                    bin_width: int = 1):
    """The ``fused_topk`` kernel's launch plan -> (cfg, QB, S, R).

    QB queries a CTA: the configuration with 8 query columns and a deep
    ring for Q <= 8, 32 columns above, each where all its queries' key
    buffers fit shared memory, else 8 columns and a short ring (larger
    k).  S splits of R live rows, R a multiple of 128 and of the bin
    width, so that about one CTA lands on each SM and each query merges
    at most 16,384 keys."""
    _, T = fused_topk_keys(k)
    order = (0, 1) if Q <= 8 else (2, 1)
    for cfg in order:
        room = kernels.SMEM_BYTES - fused_topk_smem(cfg, d, row_bytes, 0, k)
        qb = min(_FUSED_CFGS[cfg][0], Q, room // (T * 8))
        if qb >= min(_FUSED_CFGS[cfg][0], Q):
            break
    if qb < 1:
        raise ValueError(f"fused_topk: k={k} at d={d} does not fit shared memory")
    align = max(_FUSED_CHUNK, bin_width)
    units = -(-count // align) if count > 0 else 0
    tiles = -(-Q // qb)
    S = max(1, min(units, -(-_FUSED_TARGET_CTAS // tiles), _FUSED_MERGE_KEYS // k))
    R = max(1, -(-units // S)) * align
    S = max(1, -(-count // R))
    return cfg, qb, S, R


def _check_kernel_args(what: str, cap: int, d: int, dmul: int, k: int, bw: int) -> None:
    """Raise on shapes the fused_topk kernel does not take."""
    if d % dmul or d > _FUSED_MAX_D or cap % bw:
        raise ValueError(f"{what} needs d % {dmul} == 0, d <= {_FUSED_MAX_D} and cap % "
                         f"bin_width == 0; got d={d}, cap={cap}, bin_width={bw}")
    if not 1 <= k <= _KERNEL_MAX_K:
        raise ValueError(f"{what} kernel supports 1 <= k <= {_KERNEL_MAX_K}; got k={k}")
    if 128 % bw and bw % 128:
        raise ValueError(f"{what} kernel needs bin_width dividing 128 or a "
                         f"multiple of 128; got {bw}")


def _launch(name: str, E, count: int, q, k: int, bw: int, head: tuple):
    """Allocate the outputs, plan, and launch kernel ``name`` (``head``:
    its leading row arguments) -> (vals (Q, k) f32, ids (Q, k) int32)."""
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:  # the kernel reads the queries 16 bytes at a time
        qb = qb.clone()
    Q = qb.shape[0]
    cap, d = E.shape
    vals = torch.empty((Q, k), dtype=torch.float32, device=E.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=E.device)
    if Q == 0:
        return vals, ids
    count = max(0, min(int(count), cap))
    cfg, QB, S, R = fused_topk_plan(Q, k, count, d, E.element_size(), bw)
    # each split's best k keys of each query, merged by a second kernel
    ws = torch.empty((Q, S, k) if S > 1 else (0,), dtype=torch.int64, device=E.device)
    kernels.launch(
        name, *head, qb.data_ptr(), Q, d, count, k, bw, cfg, QB, S, R, ws.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), torch.cuda.current_stream(E.device).cuda_stream)
    return vals, ids


def fused_topk_raw(E, count: int, q, k: int, bin_width: Optional[int] = None):
    """Single-pass top-k over f32 or bf16 rows: E (cap, d), q (Q, d) f32
    -> (vals (Q, k) f32, ids (Q, k) int32), scores bf16(q) . bf16(row)
    summed in f32.

    On a CUDA device this launches the hand-written kernel; on the CPU
    it runs the plain version."""
    if E.device.type == "cpu":
        return fused_topk_reference(E, count, q, k, bin_width)
    bw = 1 if bin_width is None else int(bin_width)
    if E.dtype not in (torch.float32, torch.bfloat16) or not E.is_contiguous():
        raise ValueError("E must be a contiguous float32 or bfloat16 tensor")
    _check_kernel_args("fused_topk", E.shape[0], E.shape[1], 8, k, bw)
    return _launch("fused_topk", E, count, q, k, bw,
                   (E.data_ptr(), int(E.dtype == torch.bfloat16)))


def fused_topk_int8_raw(E_q, scales, count: int, q, k: int,
                        bin_width: Optional[int] = None):
    """int8 single-pass top-k: E_q (cap, d) int8, scales (cap,) or
    (cap, 1) f32, q (Q, d) f32 -> (vals (Q, k) f32, ids (Q, k) int32),
    scores (bf16(q) . float(row)) x scale summed in f32.

    On a CUDA device this launches the hand-written kernel (the int8 row
    type of ``fused_topk``'s); on the CPU it runs the plain version."""
    if E_q.device.type == "cpu":
        return fused_topk_int8_reference(E_q, scales, count, q, k, bin_width)
    cap, d = E_q.shape
    bw = 1 if bin_width is None else int(bin_width)
    if E_q.dtype != torch.int8 or not E_q.is_contiguous() or E_q.data_ptr() % 16:
        raise ValueError("E_q must be a contiguous, 16-byte aligned int8 tensor")
    _check_kernel_args("fused_topk_int8", cap, d, 16, k, bw)
    scales = scales.reshape(cap)
    if scales.dtype != torch.float32 or not scales.is_contiguous():
        scales = scales.float().contiguous()
    return _launch("fused_topk_int8", E_q, count, q, k, bw,
                   (E_q.data_ptr(), scales.data_ptr()))
