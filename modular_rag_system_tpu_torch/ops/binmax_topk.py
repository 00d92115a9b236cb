"""Two-pass top-k: the ``binmax_int8`` and ``binmax`` CUDA kernels (pass
1), the optional ``rescan`` kernel (pass 2), their plain PyTorch
versions, and the glue of the two-pass searches.

Pass 1 keeps one score maximum per bin of ``bin_width`` rows:
``binmax_int8_call`` scores int8 rows against int8-quantized queries,
``binmax_call`` f32 or bf16 rows against bf16-rounded queries.  The glue
masks dead bins, picks the best bins per query, gathers those bins' rows
(sorted ascending) and rescores them, and takes a positional top-k whose
lowest-position ties are lowest-row-id ties.  The int8 route
(``twopass_topk_int8_master_raw``) rescans the MASTER matrix, so its
scores are master-exact; the f32/bf16 route (``twopass_topk_raw``)
rescores in pass 1's own space, bf16 products summed in f32.

With ``kernel_rescan=True`` pass 2 is the ``rescan`` kernel
(``rescan_call``, ``kernels/rescan.cu``): the (query, bin) pairs sorted by
bin (``rescan_pairs``), each bin read once for each run of sorted pairs
that lists it and scored on the tensor cores, then each query's best k
selected.  It scores bf16(q) . bf16(row) in f32 on every store, an f32
master included (the TPU kernel's default precision), so on the int8
route over an f32 master its scores are bf16-product scores where the
gather path's are true f32.

``refine_against_master`` is the master rescore of the single-pass
route (kf over-selection, ``int8_refine_kf``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from modular_rag_system_tpu_torch import kernels
from modular_rag_system_tpu_torch.ops.exact import stable_topk
from modular_rag_system_tpu_torch.ops.fused_topk import _select_topk
from modular_rag_system_tpu_torch.ops.quantize import INV_127

_NEG_INF = float("-inf")
_BIG_I32 = 2**31 - 1

# bins scanned beyond the k + 1 the exactness argument needs: one margin
# bin for summation-order flips at the boundary, and two for the
# query-quantization error of the int8 pass 1
_MARGIN_BINS = 1
_INT8_MIXED_EXTRA_BINS = 2

# dead bins (entirely past ``count``) get a strictly decreasing finite
# ramp, so every selection sees distinct values and returns distinct bins
# even when fewer than kb live bins exist
_DEAD_TOP = -1.0e38
_DEAD_STEP = 2.0e32

# below this capacity the single-pass kernel is used
_MIN_TWOPASS_CAP = 8192

# rows per CTA of the binmax_int8 kernel: bins must tile it
_BINMAX_ROWS = 128

# single-pass over-selection for the master rescore; skipped past k=128
_REFINE_EXTRA_MAX = 32
_REFINE_K_MAX = 128


def int8_refine_kf(k: int, count: int) -> int:
    if k > _REFINE_K_MAX:
        return k
    return min(k + min(k, _REFINE_EXTRA_MAX), max(count, 1))


def auto_bin_width(cap: int) -> int:
    """Bin width of pass 1: 32 up to 4,194,304 rows, 64 above."""
    return 32 if cap <= 4_194_304 else 64


def binmax_int8_reference(E_q, scales, q_i8, q_scale, bin_width: int):
    """Plain PyTorch version of the kernel: (Q, cap / bin_width) f32.

    The int8 products are summed as f32 integers: every partial sum is
    an integer below 2^24 while d * 127 * 127 < 2^24, so the sum is
    exact in any order and the result is bit-exact with the kernel."""
    cap, d = E_q.shape
    if d * 127 * 127 >= 2**24:
        raise ValueError(f"d={d} too wide for exact f32 int8 sums")
    acc = E_q.float() @ q_i8.float().T  # (cap, Q), exact integers
    s = acc * scales.reshape(cap, 1) * q_scale.reshape(1, -1)
    return s.view(cap // bin_width, bin_width, -1).amax(dim=1).T.contiguous()


# the binmax_int8 kernel's query tiles (queries, ring stages), narrowest
# first: a CTA keeps its query tile in shared memory beside a ring of
# 128-row x 128-byte k-steps (kernels/binmax_int8.cu Cfg)
_BINMAX_INT8_TILES = ((16, 6), (64, 6), (128, 6), (256, 2))
_BINMAX_INT8_BK = 128


def binmax_int8_smem(bq: int, d: int) -> int:
    """Shared-memory bytes of a ``binmax_int8`` CTA with a query tile of
    ``bq``: 1 KB to align the ring, the ring, the queries (d padded to
    the k-step), their scales and a barrier per ring slot."""
    stages = dict(_BINMAX_INT8_TILES)[bq]
    dpad = -(-d // _BINMAX_INT8_BK) * _BINMAX_INT8_BK
    return (1024 + stages * _BINMAX_ROWS * _BINMAX_INT8_BK + bq * dpad + bq * 4
            + stages * 8)


@functools.lru_cache(maxsize=1024)
def binmax_int8_plan(Q: int, d: int) -> int:
    """The query tile of the ``binmax_int8`` kernel: the narrowest that
    holds all Q queries, else the widest that fits shared memory (the
    queries then take ceil(Q / tile) tiles)."""
    fits = [t[0] for t in _BINMAX_INT8_TILES
            if binmax_int8_smem(t[0], d) <= kernels.SMEM_BYTES]
    return next((bq for bq in fits if bq >= Q), fits[-1])


def binmax_int8_call(E_q, scales, q_i8, q_scale, bin_width: int):
    """(cap, d) int8 rows x (Q, d) int8 queries -> (Q, nb) per-bin maxima
    of ``float(E_q . q_i8) * scales[r] * q_scale[q]``.

    On a CUDA device this launches the hand-written kernel; on the CPU
    it runs the plain version."""
    if E_q.device.type == "cpu":
        return binmax_int8_reference(E_q, scales, q_i8, q_scale, bin_width)
    cap, d = E_q.shape
    if E_q.device.type != "cuda" or E_q.dtype != torch.int8 or not E_q.is_contiguous():
        raise ValueError("E_q must be a contiguous int8 tensor on a CUDA device")
    if d % 4 or _BINMAX_ROWS % bin_width or cap % bin_width:
        raise ValueError(f"binmax_int8 needs d % 4 == 0 and bin_width dividing "
                         f"{_BINMAX_ROWS} and cap; got d={d}, cap={cap}, "
                         f"bin_width={bin_width}")
    q_i8 = q_i8.to(torch.int8).contiguous()
    scales = scales.reshape(cap).float().contiguous()
    q_scale = q_scale.reshape(-1).float().contiguous()
    Q = q_i8.shape[0]
    out = torch.empty((Q, cap // bin_width), dtype=torch.float32, device=E_q.device)
    if Q == 0:
        return out
    kernels.launch(
        "binmax_int8", E_q.data_ptr(), q_i8.data_ptr(), scales.data_ptr(),
        q_scale.data_ptr(), cap, Q, d, bin_width, binmax_int8_plan(Q, d), out.data_ptr(),
        torch.cuda.current_stream(E_q.device).cuda_stream)
    return out


# rows per chunk of the plain binmax version: bounds its f32 transient
_REF_CHUNK_ROWS = 1 << 18

# queries per chunk of the f32/bf16 pass-2 rescore: bounds the slab gather
_RESCORE_CHUNK_Q = 32


def binmax_reference(E, q, bin_width: int):
    """Plain PyTorch version of ``binmax``: (Q, cap / bin_width) f32 per-bin
    maxima of bf16(q) . bf16(row), exact products summed in f32, in row
    chunks so the f32 copy of the rows stays small."""
    cap, _ = E.shape
    qb = q.to(torch.bfloat16).float()
    out = torch.empty((q.shape[0], cap // bin_width), dtype=torch.float32,
                      device=E.device)
    step = max(_REF_CHUNK_ROWS // bin_width, 1) * bin_width
    for s in range(0, cap, step):
        rows = E[s:s + step].to(torch.bfloat16).float()
        sc = rows @ qb.T  # (n, Q)
        n = rows.shape[0]
        out[:, s // bin_width:(s + n) // bin_width] = (
            sc.view(n // bin_width, bin_width, -1).amax(dim=1).T)
    return out


def binmax_call(E, q, bin_width: int):
    """(cap, d) f32 or bf16 rows x (Q, d) queries -> (Q, nb) per-bin maxima
    of bf16(q) . bf16(row), summed in f32.

    On a CUDA device this launches the hand-written kernel; on the CPU
    it runs the plain version."""
    if E.device.type == "cpu":
        return binmax_reference(E, q, bin_width)
    cap, d = E.shape
    if E.dtype not in (torch.float32, torch.bfloat16) or not E.is_contiguous():
        raise ValueError("E must be a contiguous float32 or bfloat16 tensor")
    if d % 8 or _BINMAX_ROWS % bin_width or cap % _BINMAX_ROWS:
        raise ValueError(f"binmax needs d % 8 == 0, bin_width dividing "
                         f"{_BINMAX_ROWS} and cap a multiple of {_BINMAX_ROWS}; "
                         f"got d={d}, cap={cap}, bin_width={bin_width}")
    qb = q.to(torch.bfloat16).contiguous()
    Q = qb.shape[0]
    out = torch.empty((Q, cap // bin_width), dtype=torch.float32, device=E.device)
    if Q == 0:
        return out
    kernels.launch(
        "binmax", E.data_ptr(), int(E.dtype == torch.bfloat16), qb.data_ptr(),
        cap, Q, d, bin_width, out.data_ptr(),
        torch.cuda.current_stream(E.device).cuda_stream)
    return out


def quantize_queries(q: torch.Tensor):
    """Per-row int8 query quantization of pass 1, in the TPU glue's order:
    ``round(q / qmax * 127)``, then clip; the scale is qmax / 127 as XLA
    computes it (times the f32 reciprocal, see ``quantize_rows``)."""
    qmax = torch.clamp(q.abs().amax(dim=1, keepdim=True), min=1e-12)
    q_i8 = torch.clamp(torch.round(q / qmax * 127.0), -127, 127).to(torch.int8)
    return q_i8, (qmax * INV_127).reshape(-1)


def _mask_bins(binmax, count: int, nb: int, bin_width: int):
    """The straddle bin (holding the live/dead boundary) is forced to +inf
    so it is always rescanned; dead bins get the decreasing ramp."""
    dev = binmax.device
    bin_base = torch.arange(nb, device=dev) * bin_width
    dead = bin_base >= count
    straddle = (bin_base < count) & (bin_base + bin_width > count)
    ramp = (torch.tensor(_DEAD_TOP, dtype=torch.float32, device=dev)
            - torch.arange(nb, dtype=torch.float32, device=dev)
            * torch.tensor(_DEAD_STEP, dtype=torch.float32, device=dev))
    bm = torch.where(dead[None, :], ramp[None, :], binmax)
    return torch.where(straddle[None, :], float("inf"), bm)


def select_bins(bm, kb: int):
    """The top-``kb`` bins of ``bm`` (Q, nb) per row, ties by lowest bin
    id, returned sorted ascending: every bin above the kb-th value, then
    the lowest-id bins equal to it."""
    v = torch.topk(bm, kb, dim=1).values[:, -1:]
    gt = bm > v
    eq = bm == v
    need = kb - gt.sum(dim=1, keepdim=True)
    take = gt | (eq & (torch.cumsum(eq, dim=1) <= need))
    return take.nonzero()[:, 1].view(bm.shape[0], kb)


def _round_to_dtype_f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 -> nearest value representable in ``dtype``, as f32."""
    if dtype != torch.bfloat16:
        return x
    return x.to(torch.bfloat16).float()


def _rescore(q_r: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (Q, n, d) -> (Q, n) in true f32 (TF32 is off on the card):
    exact products for bf16-valued operands, f32 accumulation."""
    return torch.bmm(rows, q_r.unsqueeze(2)).squeeze(2)


# candidates (kb * bin_width) one CTA of the rescan kernel sorts
_RESCAN_MAX_CANDIDATES = 16384
# the widest row: the score launch walks d in passes of k16 steps that fit
# its shared-memory budget (one or two passes at d = 768, eight at 2,048)
_RESCAN_MAX_D = 2048
# pairs a window of the rescan kernel's score launch (a run is at most
# its tensor-core tile's 8 columns), and the largest k its select launch
# takes by warp selection
_RESCAN_COLS = 8
_RESCAN_WARP_SELECT_K = 32


def narrowest_int(top: int) -> torch.dtype:
    """The narrowest signed integer type that holds 0..top: a radix sort
    of keys makes one pass a byte."""
    return next(t for t in (torch.int16, torch.int32, torch.int64)
                if top <= torch.iinfo(t).max)


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def pair_window(P: int, sms: int) -> int:
    """The sorted pairs a window of the rescan and fine_binmax kernels
    take over P pairs: ``_RESCAN_COLS`` (a run's most columns), or fewer
    where there would be fewer than two windows an SM, so small batches
    keep the card busy (1 at Q = 1, where no bin or slab is shared)."""
    return min(_RESCAN_COLS, max(1, P // (2 * sms)))


def rescan_pairs(bins: torch.Tensor, nb: int):
    """The rescan kernel's pairs: the (query, bin) pairs of bins (Q, kb)
    sorted by bin, stably, in the narrowest integer type, on the device
    with no host synchronisation -> (sorted bin ids (Q kb,), their flat
    positions in (Q, kb) int64).  The kernel cuts the sorted pairs into
    windows of ``_RESCAN_COLS`` and each window into runs of one bin.  At
    Q = 1, where a query's bins are distinct, nothing is shared: the list
    as it is, int32, and no positions (None)."""
    if bins.shape[0] == 1:
        return bins.reshape(-1).to(torch.int32).contiguous(), None
    return torch.sort(bins.reshape(-1).to(narrowest_int(max(nb - 1, 0))), stable=True)


def rescan_reference(E, bins, count: int, q, k: int, bin_width: int):
    """Plain PyTorch version of ``rescan``: gather the bins' rows, score
    bf16(q) . bf16(row) in f32, mask rows >= count, select by (score desc,
    id asc); (-inf, -1) where fewer than k live rows were scanned."""
    cap, d = E.shape
    Q, kb = bins.shape
    bins = bins.long()
    offs = torch.arange(bin_width, device=E.device)
    gid = (bins[:, :, None] * bin_width + offs).reshape(Q, kb * bin_width)
    qb = q.to(torch.bfloat16).float()
    E3 = E.view(cap // bin_width, bin_width, d)
    scores = torch.empty((Q, kb * bin_width), dtype=torch.float32, device=E.device)
    for s in range(0, Q, _RESCORE_CHUNK_Q):
        sl = slice(s, s + _RESCORE_CHUNK_Q)
        slabs = E3[bins[sl]].to(torch.bfloat16).float()  # (c, kb, bw, d)
        scores[sl] = _rescore(qb[sl], slabs.reshape(slabs.shape[0], kb * bin_width, d))
    scores = torch.where(gid < count, scores, _NEG_INF)
    if scores.shape[1] < k:
        pad = k - scores.shape[1]
        scores = torch.nn.functional.pad(scores, (0, pad), value=_NEG_INF)
        gid = torch.nn.functional.pad(gid, (0, pad), value=_BIG_I32)
    vals, ids = _select_topk(scores, gid.to(torch.int32), k)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def rescan_call(E, bins, count: int, q, k: int, bin_width: int):
    """Pass 2 in two launches: E (cap, d) f32 or bf16, bins (Q, kb)
    distinct bin ids per query, q (Q, d) f32 -> (vals (Q, k) f32, ids (Q, k)
    int32): the top k rows of the query's bins below ``count`` by
    bf16(q) . bf16(row) summed in f32, ties to the smallest id.

    On a CUDA device this sorts the pairs by bin (``rescan_pairs``) and
    launches the hand-written kernel; on the CPU it runs the plain
    version."""
    if E.device.type == "cpu":
        return rescan_reference(E, bins, count, q, k, bin_width)
    cap, d = E.shape
    Q, kb = bins.shape
    if E.dtype not in (torch.float32, torch.bfloat16) or not E.is_contiguous():
        raise ValueError("E must be a contiguous float32 or bfloat16 tensor")
    if (d % 8 or d > _RESCAN_MAX_D or cap % bin_width or bin_width % 16 or bin_width > 64 or k < 1
            or E.data_ptr() % 16):
        raise ValueError(f"rescan needs d % 8 == 0, d <= {_RESCAN_MAX_D}, cap % bin_width == 0, "
                         f"bin_width a multiple of 16 up to 64, k >= 1 and E 16-byte "
                         f"aligned; got d={d}, cap={cap}, bin_width={bin_width}, k={k}")
    if not 1 <= kb * bin_width <= _RESCAN_MAX_CANDIDATES:
        raise ValueError(f"rescan sorts at most {_RESCAN_MAX_CANDIDATES} candidates a "
                         f"query; got kb={kb} x bin_width={bin_width}")
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:  # the kernel copies the queries 16 bytes at a time
        qb = qb.clone()
    vals = torch.empty((Q, k), dtype=torch.float32, device=E.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=E.device)
    if Q == 0:
        return vals, ids
    keys, perm = rescan_pairs(bins, cap // bin_width)
    ws = torch.empty((Q, kb * bin_width), dtype=torch.int64, device=E.device)
    kernels.launch(
        "rescan", E.data_ptr(), int(E.dtype == torch.bfloat16), qb.data_ptr(),
        keys.data_ptr(), keys.element_size(), None if perm is None else perm.data_ptr(),
        pair_window(Q * kb, _sm_count(E.device)), Q, d, int(count), kb,
        bin_width, k, ws.data_ptr(), 3, int(k <= _RESCAN_WARP_SELECT_K), vals.data_ptr(),
        ids.data_ptr(), torch.cuda.current_stream(E.device).cuda_stream)
    return vals, ids


def twopass_topk_int8_master_raw(E_q, scales, E_master, count: int, q, k: int,
                                 bin_width: int,
                                 extra_bins: int = _INT8_MIXED_EXTRA_BINS,
                                 kernel_rescan: bool = False):
    """Mixed two-pass: int8 pass 1 selects bins, pass 2 rescans the
    master (f32 or bf16) rows of those bins.  Returns (vals (Q, k) f32,
    ids (Q, k) int32), ties by lowest row id; scores are master-exact,
    the top-k set is bounded by pass-1 bin coverage.  ``kernel_rescan``
    runs pass 2 as the ``rescan`` kernel (bf16-product scores, also on an
    f32 master) in place of the gather."""
    cap, d = E_q.shape
    nb = cap // bin_width
    q = q.float()
    q_i8, q_scale = quantize_queries(q)
    binmax = binmax_int8_call(E_q, scales, q_i8, q_scale, bin_width)  # (Q, nb)
    bm = _mask_bins(binmax, count, nb, bin_width)
    kb = min(k + 1 + _MARGIN_BINS + extra_bins, nb)
    bins = select_bins(bm, kb)  # (Q, kb) ascending
    if kernel_rescan:
        return rescan_call(E_master, bins, count, q, k, bin_width)
    offs = torch.arange(bin_width, device=bins.device)
    rid_flat = (bins[:, :, None] * bin_width + offs).reshape(q.shape[0], -1)
    slabs = E_master.view(nb, bin_width, d)[bins].float()
    q_r = _round_to_dtype_f32(q, E_master.dtype)
    scores = _rescore(q_r, slabs.reshape(q.shape[0], kb * bin_width, d))
    scores = torch.where(rid_flat < count, scores, _NEG_INF)
    vals, pos = stable_topk(scores, k)
    return vals, torch.gather(rid_flat, 1, pos).to(torch.int32)


def twopass_topk_raw(E, count: int, q, k: int, bin_width: int,
                     kernel_rescan: bool = False):
    """Two-pass top-k over f32 or bf16 rows (the fused/bf16 tiers at
    capacity >= ``_MIN_TWOPASS_CAP``): ``binmax`` pass 1 selects
    ``k + 1 + _MARGIN_BINS`` bins, pass 2 rescores their rows in the same
    space, bf16(q) . bf16(row) summed in f32 (the TPU tiers' similarity
    contract: default-precision products in every store dtype).
    Returns (vals (Q, k) f32, ids (Q, k) int32), ties by lowest row id;
    exact within that space up to the margin bin.  ``kernel_rescan`` runs
    pass 2 as the ``rescan`` kernel in place of the gather (the same
    scoring space)."""
    cap, d = E.shape
    nb = cap // bin_width
    Q = q.shape[0]
    q = q.float()
    binmax = binmax_call(E, q, bin_width)  # (Q, nb)
    bm = _mask_bins(binmax, count, nb, bin_width)
    kb = min(k + 1 + _MARGIN_BINS, nb)
    bins = select_bins(bm, kb)  # (Q, kb) ascending
    if kernel_rescan:
        return rescan_call(E, bins, count, q, k, bin_width)
    offs = torch.arange(bin_width, device=bins.device)
    rid_flat = (bins[:, :, None] * bin_width + offs).reshape(Q, -1)
    q_r = _round_to_dtype_f32(q, torch.bfloat16)
    E3 = E.view(nb, bin_width, d)
    vals = torch.empty((Q, k), dtype=torch.float32, device=E.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=E.device)
    for s in range(0, Q, _RESCORE_CHUNK_Q):
        sl = slice(s, s + _RESCORE_CHUNK_Q)
        slabs = E3[bins[sl]].to(torch.bfloat16).float()  # (c, kb, bw, d)
        scores = _rescore(q_r[sl], slabs.reshape(slabs.shape[0], kb * bin_width, d))
        scores = torch.where(rid_flat[sl] < count, scores, _NEG_INF)
        v, pos = stable_topk(scores, k)
        vals[sl] = v
        ids[sl] = torch.gather(rid_flat[sl], 1, pos).to(torch.int32)
    return vals, ids


def refine_against_master(E, q, rows, k: int, cand_vals: Optional[torch.Tensor] = None):
    """Rescore candidate ``rows`` (Q, kf) against the master matrix and
    return the top-k among them by (score desc, id asc); slots with a
    non-finite candidate score are masked out first."""
    if cand_vals is not None:
        rows = torch.where(torch.isfinite(cand_vals), rows, -1)
    cand = E[rows.clamp(min=0).long()].float()  # (Q, kf, d)
    q_r = _round_to_dtype_f32(q.float(), E.dtype)
    scores = torch.where(rows >= 0, _rescore(q_r, cand), _NEG_INF)
    ids = torch.where(rows >= 0, rows, _BIG_I32)
    vals, out = _select_topk(scores, ids, k)
    return vals, torch.where(torch.isfinite(vals), out, -1).to(torch.int32)
