"""IVF2 — the cluster-contiguous ANN tier with an exact streamed tail.

The port of the JAX package's ``ops/ivf2.py`` (bf16, int8 and int4 fine
copies):

* **Build.**  Spherical k-means (``ops/kmeans.py``, optionally LBG-split
  so no cluster passes ``balance`` x the average), then the rows are laid
  out cluster by cluster in a (nblocks, SLAB, d) fine copy: cluster ``c``
  owns blocks ``[blk_start[c], blk_start[c] + nblk[c])``.  ``perm`` maps a
  slot to its global row (-1 = padding), ``inv_perm`` a row to its slot
  (its last entry is a trash row that absorbs the writes of padding
  slots).
* **Search** (``ivf2_search_core``).  Coarse probe of the ``nprobe`` best
  centroids, per-query block lists (``block_lists``), the fine stage over
  those slabs, an exact scan of the rows written since the build (the
  tail window of the master matrix), and a rescore of every candidate on
  the master, so returned scores are master-exact.
* **Fine stage.**  ``fine_call_auto`` keeps the JAX dispatch: the
  score-dump path (``fine_scores`` kernel, ``kernels/fine_scores.cu``,
  then one positional selection) while its score buffer is affordable,
  the selecting kernel (``fine_topk``, ``kernels/fine_topk.cu``) past
  ``_DUMP_MAX_BYTES`` in total or ``_DUMP_VMEM_BYTES`` per query.  The
  limits were set for the TPU's memories; they are kept because they
  choose the kernel, so the dispatch stays the JAX package's.

* **int4 fine copy** (``fine_dtype="int4"``).  Two logical rows share a
  byte (row r in the high nibble, row r + SLAB/2 in the low one,
  ``ops/quantize.py``), so a block is (SLAB/2, d) int8 and the fine copy
  half the int8 copy's bytes.  What is quantized is the RESIDUAL
  row - centroid; the exact q . centroid term comes back from the coarse
  score table as a per-slot ``bias`` added after the score dump, so the
  4-bit scores only rank candidates, over-selected in proportion to the
  probed pool (``refine_extra``), and the master rescore keeps returned
  scores exact.  A bias needs the dump path: the selecting kernel would
  rank biasless scores across clusters, so it is refused there.

The fine kernels score ``bf16(q) . row`` in f32 (int8 and int4 rows times
their scale after the dot); slots past a block's valid count score -inf.
``fine_binmax`` (``kernels/fine_binmax.cu``) keeps only each slot's
maximum, bit-equal to the dump's (tensor-core scores certify which rows
can hold it, and only those are scored again with ``fine_scores``'
arithmetic): the streaming floor beside which the other two are timed, on
no serving path.  A wrapper launches its kernel for tensors on a CUDA device
and runs its plain version for tensors on the CPU.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from modular_rag_system_tpu_torch import kernels
from modular_rag_system_tpu_torch.ops.binmax_topk import (
    _rescore,
    _round_to_dtype_f32,
    _sm_count,
    narrowest_int,
    pair_window,
)
from modular_rag_system_tpu_torch.ops.exact import stable_topk
from modular_rag_system_tpu_torch.ops.fused_topk import _select_topk
from modular_rag_system_tpu_torch.ops.kmeans import init_centroids_from_rows, kmeans_fit
from modular_rag_system_tpu_torch.ops.quantize import (
    int4_scale_and_values,
    quantize_int4_blocks,
    quantize_rows,
    unpack_int4_values,
)

logger = logging.getLogger(__name__)

SLAB = 256  # rows per fine-copy block
_NEG_INF = float("-inf")
_BIG_I32 = 2**31 - 1

# dump-path limits of the JAX package (they pick the fine kernel)
_DUMP_MAX_BYTES = 1 << 31
_DUMP_VMEM_BYTES = 4 << 20
# cap of the master rescore's (Q, kf, d) f32 gather under the int4
# default over-selection, which grows with the probed pool
_RESCORE_MAX_BYTES = 1 << 30

# (query, slot) pairs the fine_scores plan gives a CTA at most (the kernel
# takes up to 16, kernels/fine_scores.cu MAX_P; 16 was no faster than 8 at
# the smoke's lists, chip_smoke.py time_fine)
_FINE_SCORES_MAX_P = 8
# the selecting kernel's largest running top-k
_FINE_TOPK_MAX_K = 8192
# candidate keys a query's partial lists may hold in the fine_topk merge
_FINE_MERGE_KEYS = 4096
# f32 bytes of one chunk of the plain fine versions' slab gather
_REF_CHUNK_BYTES = 1 << 28
# rows per chunk of the tail scan over a bf16 master
_TAIL_CHUNK_ROWS = 1 << 16

def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def check_fine_dtype(fine_dtype: str) -> None:
    if fine_dtype not in ("auto", "bf16", "int8", "int4"):
        raise ValueError(f"ivf_fine_dtype must be auto|bf16|int8|int4, got {fine_dtype}")


# ---------------------------------------------------------------------------
# build: cluster-sorted order + contiguous slab fill
def order_counts_core(labels: torch.Tensor, count: int, C: int):
    """Stable cluster sort of the row ids -> (order (cap,), counts (C,))."""
    cap = labels.shape[0]
    i = torch.arange(cap, device=labels.device)
    valid = (i < count) & (labels >= 0)
    lab = torch.where(valid, labels.long(), C)
    order = torch.argsort(lab, stable=True)
    counts = torch.bincount(lab, minlength=C + 1)[:C]
    return order.to(torch.int32), counts.to(torch.int32)


def _fill_chunk_core(E_c3, scales3, perm, inv_perm, E, order, counts, blk_start,
                     row_start, block_cluster, centroids, lo: int, nb: int,
                     fine_dtype: str):
    """Fill destination blocks [lo, lo + nb) in place.  The int4 copy
    stores the residual row - centroid of the block's cluster."""
    d = E.shape[1]
    dev = E.device
    b = lo + torch.arange(nb, device=dev)
    c = block_cluster[torch.clamp(b, max=block_cluster.shape[0] - 1)].long()
    pos = (b - blk_start[c])[:, None] * SLAB + torch.arange(SLAB, device=dev)
    valid = pos < counts[c][:, None]
    src_sorted = row_start[c][:, None] + torch.clamp(pos, min=0)
    src = order[torch.clamp(src_sorted, 0, order.shape[0] - 1)].long()
    pm = torch.where(valid, src, -1).reshape(-1)
    rows = E[src.reshape(-1)].float()
    rows = torch.where(valid.reshape(-1)[:, None], rows, 0.0)
    if fine_dtype == "int8":
        qv, sc = quantize_rows(rows)
        E_c3[lo:lo + nb] = qv.view(nb, SLAB, d)
        scales3[lo:lo + nb] = sc.view(nb, SLAB)
    elif fine_dtype == "int4":
        res = rows.view(nb, SLAB, d) - centroids[c].float()[:, None, :]
        res = torch.where(valid[..., None], res, 0.0)
        E_c3[lo:lo + nb], scales3[lo:lo + nb] = quantize_int4_blocks(
            res.view(nb * SLAB, d), nb, SLAB)
    else:
        E_c3[lo:lo + nb] = rows.to(E_c3.dtype).view(nb, SLAB, d)
    perm[lo * SLAB:(lo + nb) * SLAB] = pm.to(torch.int32)
    slot_ids = lo * SLAB + torch.arange(nb * SLAB, device=dev)
    # padding slots write -1 into the trash row (the last entry): aiming
    # them at a real row would race that row's own write
    tgt = torch.where(pm >= 0, pm, inv_perm.shape[0] - 1)
    inv_perm[tgt] = torch.where(pm >= 0, slot_ids, -1).to(torch.int32)


def lbg_split_seeds(centroids_h: np.ndarray, cnts: np.ndarray, cap_rows: int,
                    rng: np.random.Generator):
    """Jittered centroid copies for clusters past ``cap_rows`` rows, or
    None when every cluster fits (the LBG split move)."""
    extra = np.maximum(np.ceil(cnts / cap_rows).astype(np.int64) - 1, 0)
    if int(extra.sum()) == 0:
        return None
    src = np.repeat(np.arange(len(cnts)), extra)
    base = np.asarray(centroids_h, np.float32)[src]
    d = base.shape[1]
    seeds = base + rng.standard_normal(base.shape).astype(np.float32) * (
        0.05 / np.sqrt(d))
    seeds /= np.maximum(np.linalg.norm(seeds, axis=1, keepdims=True), 1e-12)
    return seeds


def _split_oversized(E, count: int, centroids, labels, balance: float,
                     seed_batch: int, rounds: int = 2):
    """Split clusters larger than ``balance * count / C0`` rows by seeding
    jittered copies of their centroid and re-running a short Lloyd's.
    0 = off."""
    if not balance or count == 0:
        return centroids, labels
    C0 = centroids.shape[0]
    cap_rows = max(int(np.ceil(balance * count / C0)), SLAB)
    rng = np.random.default_rng(0)
    for _ in range(rounds):
        Ccur = centroids.shape[0]
        lab = torch.where(labels >= 0, labels.long(), Ccur)
        cnts = torch.bincount(lab, minlength=Ccur + 1)[:Ccur].cpu().numpy()
        seeds = lbg_split_seeds(centroids.cpu().numpy(), cnts, cap_rows, rng)
        if seeds is None:
            break
        cents = torch.cat([centroids, torch.from_numpy(seeds).to(centroids.device)])
        centroids, labels = kmeans_fit(E, count, cents, iters=3, batch=seed_batch)
    return centroids, labels


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> tensor; a bfloat16 array (ml_dtypes) travels as its bits."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class IVF2:
    """Built cluster-contiguous structure.

    ``E_c3`` (nblocks, SLAB, d) bf16 or int8 fine copy, or (nblocks,
    SLAB / 2, d) int8 holding two int4 rows a byte; ``scales3``
    (nblocks, SLAB) f32 row scales (int8 and int4, else None);
    ``block_cluster`` (nblocks,) int32 block -> cluster (the int4 row
    updates need each slot's centroid); ``perm``
    (nblocks * SLAB,) int32 slot -> global row (-1 padding); ``inv_perm``
    (capacity + 1,) int32 global row -> slot (-1 if unbuilt; the last
    entry is the trash row); cluster tables ``blk_start``/``nblk``/
    ``counts`` (C,) int32 on the device, ``nblk_h`` on the host.  Rows
    [0, built) are clustered; later rows are the exact tail."""

    def __init__(self, centroids, E_c3, scales3, perm, inv_perm, blk_start, nblk,
                 counts, built: int, fine_dtype: str, block_cluster=None) -> None:
        check_fine_dtype(fine_dtype)
        self.centroids = centroids
        self.block_cluster = block_cluster
        self.E_c3 = E_c3
        self.scales3 = scales3
        self.perm = perm
        self.inv_perm = inv_perm
        self.blk_start = blk_start
        self.nblk = nblk
        self.counts = counts
        self.nblk_h = nblk.cpu().numpy()
        self.built = int(built)
        self.fine_dtype = fine_dtype
        self.version = 0
        # True when build() took a (centroids, labels) warm start
        self.warm_started = False
        # rows rewritten since the build (drift): a rebuild folds them in
        self.stale_rows = 0

    @property
    def n_clusters(self) -> int:
        return int(self.nblk_h.shape[0])

    @property
    def nblocks(self) -> int:
        return int(self.E_c3.shape[0])

    def fine_bytes(self) -> int:
        return self.E_c3.numel() * self.E_c3.element_size()

    def memory_bytes(self) -> int:
        """Device bytes: fine copy, scales, slot maps, centroids."""
        b = self.fine_bytes() + 4 * (self.perm.numel() + self.inv_perm.numel()
                                     + self.centroids.numel())
        return b + (0 if self.scales3 is None else 4 * self.scales3.numel())

    def slots_for_nprobe(self, nprobe: int) -> int:
        """Per-query slot budget: the block counts of the nprobe largest
        clusters (the worst case over any probe set)."""
        nprobe = min(nprobe, self.n_clusters)
        top = np.sort(self.nblk_h)[::-1][:nprobe]
        return max(int(top.sum()), 1)

    def labels_host(self) -> np.ndarray:
        """Per-row cluster labels of rows [0, built), from the slot
        permutation (saved beside the centroids for a warm start)."""
        perm_h = self.perm.cpu().numpy()
        bc = np.repeat(np.arange(self.n_clusters, dtype=np.int32),
                       self.nblk_h.astype(np.int64))
        labels = np.full(self.built, -1, np.int32)
        slots = np.nonzero(perm_h >= 0)[0]
        rows = perm_h[slots]
        keep = rows < self.built
        labels[rows[keep]] = bc[slots[keep] // SLAB]
        return labels

    @classmethod
    def from_numpy(cls, arrays, built: int, fine_dtype: str, device="cuda") -> "IVF2":
        """An IVF2 from another build's arrays given as numpy (e.g. a JAX
        ``IVF2``'s ``centroids``, ``E_c3``, ``scales3``, ``perm``,
        ``inv_perm``, ``blk_start``, ``nblk``, ``counts`` and, optionally,
        ``block_cluster``), placed on ``device``."""
        dev = torch.device(device)
        t = {name: (None if a is None else _from_numpy(a).to(dev))
             for name, a in arrays.items()}
        return cls(t["centroids"], t["E_c3"],
                   t["scales3"] if fine_dtype in ("int8", "int4") else None,
                   t["perm"], t["inv_perm"], t["blk_start"], t["nblk"], t["counts"],
                   built, fine_dtype, block_cluster=t.get("block_cluster"))

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, E, count: int, n_clusters: Optional[int] = None, iters: int = 10,
              fine_dtype: str = "bf16", seed_batch: int = 65536, balance: float = 0.0,
              warm_start: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> "IVF2":
        """Cluster rows [0, count) of the master matrix ``E`` and lay the
        fine copy out cluster-contiguously on E's device.

        ``warm_start`` = (centroids (C, d) f32, labels (count,) int32)
        skips the k-means and the splits and goes straight to the fill;
        labels outside [0, C) fall back to a cold build."""
        count = int(count)
        check_fine_dtype(fine_dtype)
        if fine_dtype == "auto":
            raise ValueError("IVF2.build needs a resolved fine_dtype (bf16|int8|int4)")
        cap, d = E.shape
        dev = E.device
        if warm_start is not None:
            cents_h, labels_h = warm_start
            if len(labels_h) != count:
                raise ValueError(f"warm_start labels cover {len(labels_h)} rows, "
                                 f"build count is {count}")
            labels_arr = np.asarray(labels_h, np.int32)
            if count and (labels_arr.min() < 0 or labels_arr.max() >= cents_h.shape[0]):
                logger.warning("warm_start labels out of range [0, %d); ignoring "
                               "snapshot clustering and re-running k-means",
                               cents_h.shape[0])
                warm_start = None
        if warm_start is not None:
            centroids = torch.tensor(np.asarray(cents_h, np.float32), device=dev)
            labels = torch.full((cap,), -1, dtype=torch.int32, device=dev)
            labels[:count] = torch.from_numpy(labels_arr).to(dev)
        else:
            if n_clusters is None:
                n_clusters = int(max(8, min(count, round(count ** 0.5))))
            C = min(max(n_clusters, 1), max(count, 1))
            if count:
                seed_idx = torch.from_numpy(
                    np.linspace(0, count - 1, C).astype(np.int64)).to(dev)
                seed_rows = E[seed_idx].float().cpu().numpy()
            else:
                seed_rows = np.zeros((1, d), np.float32)
            init = init_centroids_from_rows(seed_rows, len(seed_rows), C)
            centroids, labels = kmeans_fit(E, count, init, iters=iters, batch=seed_batch)
            centroids, labels = _split_oversized(E, count, centroids, labels, balance,
                                                 seed_batch)
        C = int(centroids.shape[0])
        order, counts = order_counts_core(labels, count, C)
        counts_h = counts.cpu().numpy().astype(np.int64)
        nblk_h = np.maximum((counts_h + SLAB - 1) // SLAB, 0)
        blk_start_h = np.cumsum(nblk_h) - nblk_h
        row_start_h = np.cumsum(counts_h) - counts_h
        nblocks = max(int(nblk_h.sum()), 1)
        # the fill runs in chunks of CHUNK_BLOCKS blocks (bounds the f32
        # gather); the layout is padded to a chunk multiple as in JAX
        CHUNK_BLOCKS = min(1024, 1 << max(nblocks - 1, 1).bit_length())
        nblocks_pad = _cdiv(nblocks, CHUNK_BLOCKS) * CHUNK_BLOCKS
        block_cluster_h = np.full(nblocks_pad, C - 1, np.int32)
        block_cluster_h[:nblocks] = np.repeat(np.arange(C, dtype=np.int32),
                                              nblk_h.astype(np.int64))

        def dev_i32(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

        blk_start, nblk, counts_d = dev_i32(blk_start_h), dev_i32(nblk_h), dev_i32(counts_h)
        row_start, block_cluster = dev_i32(row_start_h), dev_i32(block_cluster_h)
        fdt = torch.bfloat16 if fine_dtype == "bf16" else torch.int8
        slab_p = SLAB // 2 if fine_dtype == "int4" else SLAB
        E_c3 = torch.zeros((nblocks_pad, slab_p, d), dtype=fdt, device=dev)
        scales3 = (torch.zeros((nblocks_pad, SLAB), dtype=torch.float32, device=dev)
                   if fine_dtype in ("int8", "int4") else None)
        perm = torch.full((nblocks_pad * SLAB,), -1, dtype=torch.int32, device=dev)
        inv_perm = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
        for lo in range(0, nblocks_pad, CHUNK_BLOCKS):
            _fill_chunk_core(E_c3, scales3, perm, inv_perm, E, order, counts_d,
                             blk_start, row_start, block_cluster, centroids, lo,
                             CHUNK_BLOCKS, fine_dtype)
        iv = cls(centroids, E_c3, scales3, perm, inv_perm, blk_start, nblk, counts_d,
                 count, fine_dtype, block_cluster=block_cluster)
        iv.warm_started = warm_start is not None
        return iv

    # ------------------------------------------------------------------
    def update_rows(self, rows: np.ndarray, mat) -> None:
        """Write rewritten (``mat``) or deleted (``mat`` None: zero) built
        rows into the fine copy in place; tail rows are untouched (the
        tail reads the master).  A row keeps its old cluster until the
        next rebuild (counted as drift)."""
        r0 = np.asarray(rows, dtype=np.int64)
        mask = r0 < self.built
        r = r0[mask]
        if r.size == 0:
            return
        if self.fine_dtype == "int4" and self.block_cluster is None:
            # the residual re-quantization needs each slot's centroid
            raise ValueError(
                "IVF2.update_rows with fine_dtype='int4' requires "
                "block_cluster (per-block cluster ids); this instance "
                "was constructed without it — use IVF2.build()")
        dev = self.E_c3.device
        if mat is None:
            vals = torch.zeros((len(r), self.E_c3.shape[2]), dtype=torch.float32, device=dev)
        else:
            m = torch.as_tensor(mat).to(dev, torch.float32)
            vals = m[torch.from_numpy(np.nonzero(mask)[0]).to(dev)]
        slots = self.inv_perm[torch.from_numpy(r).to(dev)]
        _scatter_slots(self.E_c3, self.scales3, slots, vals, self.fine_dtype,
                       self.centroids, self.block_cluster)
        self.stale_rows += len(r)


def _int4_nibble_rmw(packed_rows, qvals, hi: bool):
    """Read-modify-write one nibble of gathered packed bytes:
    ``packed_rows`` (B, d) int8, ``qvals`` (B, d) int32 in [-7, 7] ->
    the new (B, d) int8 bytes, the other nibble kept."""
    old = packed_rows.to(torch.int32) & 0xFF  # the byte as unsigned
    qn = qvals & 0xF
    new = ((qn << 4) | (old & 0xF)) if hi else ((old & 0xF0) | qn)
    return torch.where(new >= 128, new - 256, new).to(torch.int8)


def _scatter_slots(E_c3, scales3, slots, vals, fine_dtype: str, centroids=None,
                   block_cluster=None) -> None:
    """Scatter rows into the fine copy in place; slots < 0 (rows not in
    the build) are dropped, never written back."""
    ok = slots >= 0
    s = slots[ok].long()
    v = vals[ok]
    b, rr = s // SLAB, s % SLAB
    if fine_dtype == "int8":
        qv, sc = quantize_rows(v)
        E_c3[b, rr] = qv
        scales3[b, rr] = sc[:, 0]
    elif fine_dtype == "int4":
        # one nibble per row: residual-quantize as the fill does, then two
        # read-modify-write phases (high-nibble rows, then low-nibble
        # rows), so a batch that updates both rows of one byte loses
        # neither nibble (an in-place indexed write with duplicate
        # indices keeps an arbitrary one)
        S = E_c3.shape[1]
        qv, sc = int4_scale_and_values(v.float() - centroids[block_cluster[b].long()].float())
        pr, is_hi = rr % S, rr < S
        for hi in (True, False):
            sel = is_hi == hi
            bs, ps = b[sel], pr[sel]
            E_c3[bs, ps] = _int4_nibble_rmw(E_c3[bs, ps], qv[sel], hi)
        scales3[b, rr] = sc[:, 0]
    else:
        E_c3[b, rr] = v.to(E_c3.dtype)


# ---------------------------------------------------------------------------
# fine stage: the two kernels and their plain versions
_MODE_IDS = {"bf16": 0, "int8": 1, "int4": 2}


def _fine_mode(E_c3) -> str:
    """Storage mode of a fine copy, from its dtype and shape: int4 packs
    two logical rows a byte along the slab, so its blocks are
    (SLAB / 2, d) int8 (``ops.quantize.quantize_int4_blocks``)."""
    if E_c3.dtype == torch.int8:
        return "int4" if E_c3.shape[1] == SLAB // 2 else "int8"
    return "bf16"


def _check_fine_operands(E_c3, scales3, blk, vcnt, what: str) -> str:
    """Raise on operands the fine kernels do not take; returns the mode."""
    nblocks, S, d = E_c3.shape
    if E_c3.dtype not in (torch.bfloat16, torch.int8) or not E_c3.is_contiguous():
        raise ValueError(f"{what}: E_c3 must be a contiguous bf16 or int8 tensor")
    mode = _fine_mode(E_c3)
    if S != (SLAB // 2 if mode == "int4" else SLAB) or d % 16 or d > 1024:
        raise ValueError(f"{what} needs (nblocks, {SLAB}, d) slabs ((nblocks, "
                         f"{SLAB // 2}, d) int8 for int4) with d % 16 == 0 and "
                         f"d <= 1024; got {tuple(E_c3.shape)}")
    if mode != "bf16" and (scales3 is None or scales3.shape != (nblocks, SLAB)):
        raise ValueError(f"{what}: an {mode} fine copy needs scales3 "
                         f"({nblocks}, {SLAB})")
    if blk.shape != vcnt.shape or blk.shape[0] > 65535:
        raise ValueError(f"{what}: blk {tuple(blk.shape)} and vcnt "
                         f"{tuple(vcnt.shape)} must match, with at most 65535 queries")
    return mode


def _kernel_operands(E_c3, scales3, q, blk, vcnt, mode: str):
    """The fine kernels' common arguments: bf16 queries, int32 lists and
    a scales pointer (any valid pointer where the mode reads none)."""
    qb = q.to(torch.bfloat16).contiguous()
    sc = scales3.contiguous() if mode != "bf16" else qb
    return qb, blk.to(torch.int32).contiguous(), vcnt.to(torch.int32).contiguous(), sc


def _slab_scores_reference(E_c3, scales3, q, blk, vcnt):
    """(Q, L, SLAB) f32 scores of bf16(q) . row (int8 and int4 rows x
    their scale; int4 blocks unpacked first), -inf at positions >= vcnt,
    in query chunks."""
    Q, L = blk.shape
    d = E_c3.shape[2]
    int4 = _fine_mode(E_c3) == "int4"
    qb = q.to(torch.bfloat16).float()
    out = torch.empty((Q, L, SLAB), dtype=torch.float32, device=E_c3.device)
    iota = torch.arange(SLAB, device=E_c3.device)
    step = max(_REF_CHUNK_BYTES // max(L * SLAB * d * 4, 1), 1)
    for s in range(0, Q, step):
        sl = slice(s, s + step)
        b = blk[sl].long()
        tiles = E_c3[b]
        tiles = (unpack_int4_values(tiles) if int4 else tiles).float()  # (c, L, SLAB, d)
        sc = (tiles.reshape(tiles.shape[0], L * SLAB, d) @ qb[sl, :, None])[..., 0]
        sc = sc.view(-1, L, SLAB)
        if scales3 is not None:
            sc = sc * scales3[b]
        out[sl] = torch.where(iota < vcnt[sl, :, None], sc, _NEG_INF)
    return out


def fine_scores_reference(E_c3, scales3, q, blk, vcnt):
    """Plain PyTorch version of ``fine_scores``: (Q, L * SLAB) f32."""
    Q, L = blk.shape
    return _slab_scores_reference(E_c3, scales3, q, blk, vcnt).reshape(Q, L * SLAB)


def fine_scores_plan(Q: int, L: int, d: int, mode: str, sms: int) -> int:
    """The ``fine_scores`` kernel's launch plan -> P, the (query, slot)
    pairs sorted by block that one CTA takes: a CTA reads a slab once for
    all its pairs that list it, so P is as large as leaves about four CTAs
    an SM, at most ``_FINE_SCORES_MAX_P``, with the P queries (P d f32) in
    shared memory.  P = 1 (one CTA a pair, no sort) at Q = 1, where no two
    pairs share a query's distinct blocks, and for an int4 copy: its slab
    is half an int8 slab's bytes and each byte two conversions, so the
    kernel is bound by the CUDA cores there and the pair sort costs more
    than reading each slab once saves (``chip_smoke.py`` times both)."""
    if Q <= 1 or mode == "int4":
        return 1
    P = min(Q * L // (4 * sms), _FINE_SCORES_MAX_P, kernels.SMEM_BYTES // (4 * d))
    return max(P, 1)


def fine_scores_call(E_c3, scales3, q, blk, vcnt):
    """Every candidate row's score, streamed: E_c3 (nblocks, SLAB, d) bf16
    or int8, or (nblocks, SLAB / 2, d) packed int4 (+ scales3 (nblocks,
    SLAB) f32), q (Q, d) f32, per-query block lists blk/vcnt (Q, L) int32
    -> (Q, L * SLAB) f32, -inf at positions >= vcnt.

    On a CUDA device this launches the hand-written kernel, its pairs
    sorted by block on the device (``fine_pair_keys``, one query tile)
    where the plan gives a CTA more than one; on the CPU it runs the plain
    version."""
    if E_c3.device.type == "cpu":
        return fine_scores_reference(E_c3, scales3, q, blk, vcnt)
    mode = _check_fine_operands(E_c3, scales3, blk, vcnt, "fine_scores")
    nblocks, _, d = E_c3.shape
    Q, L = blk.shape
    dev = E_c3.device
    qb, blk, vcnt, sc = _kernel_operands(E_c3, scales3, q, blk, vcnt, mode)
    out = torch.empty((Q, L * SLAB), dtype=torch.float32, device=dev)
    if Q == 0 or L == 0:
        return out
    P = fine_scores_plan(Q, L, d, mode, _sm_count(dev))
    perm = fine_pair_keys(blk, vcnt, Q, nblocks)[1] if P > 1 else None
    kernels.launch(
        "fine_scores", E_c3.data_ptr(), _MODE_IDS[mode], sc.data_ptr(), qb.data_ptr(),
        blk.data_ptr(), vcnt.data_ptr(), None if perm is None else perm.data_ptr(), Q, L, d,
        P, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out


def fine_binmax_reference(E_c3, scales3, q, blk, vcnt):
    """Plain PyTorch version of ``fine_binmax``: the row maximum of the
    score dump per slot, (Q, L) f32, -inf for a dead slot."""
    return _slab_scores_reference(E_c3, scales3, q, blk, vcnt).amax(dim=2)


# pairs a window of the fine_binmax kernel (a run is at most its
# tensor-core tile's 8 columns), and its ring stages by mode
_FINE_BINMAX_COLS = 8
_FINE_BINMAX_STAGES = {"bf16": 3, "int8": 3, "int4": 5}


def fine_binmax_smem(d: int, mode: str) -> int:
    """Shared-memory bytes of a ``fine_binmax`` CTA: the slab ring (a
    k-step is a TMA box of the stored rows x 64 bytes, with its mbarrier),
    two run descriptors, two query tiles (bf16, padded by 16 bytes), the
    score tile and its error-bound tile, and each warp's f32 query."""
    stored = SLAB // 2 if mode == "int4" else SLAB
    stages = _FINE_BINMAX_STAGES[mode]
    dpad = _cdiv(d, 64) * 64
    return (stages * stored * 64 + _cdiv(stages * 8, 16) * 16 + 2 * 72
            + 2 * _FINE_BINMAX_COLS * (dpad + 8) * 2 + 2 * _FINE_BINMAX_COLS * (SLAB + 4) * 4
            + 8 * dpad * 4)


def fine_binmax_pairs(blk, vcnt, nblocks: int):
    """The fine_binmax kernel's pairs: ``fine_pair_keys`` with one tile
    (blocks sorted, dead slots keyed ``nblocks``, last) -> (sorted keys,
    flat positions); (None, None) at Q = 1, where no two pairs share a
    block and the kernel takes the pairs in list order."""
    if blk.shape[0] <= 1:
        return None, None
    return fine_pair_keys(blk, vcnt, blk.shape[0], nblocks)


def fine_binmax_call(E_c3, scales3, q, blk, vcnt, cand_counts=None):
    """Per (query, list slot) the maximum score of the slab's live rows:
    operands as ``fine_scores_call`` -> (Q, L) f32, -inf for a dead slot,
    bit-equal to the row maxima of ``fine_scores_call``'s dump.  The same
    reads as the other fine kernels with no selection and almost no
    output: their streaming floor, on no serving path.  ``cand_counts``,
    a (Q, L) int32 tensor on the card, receives each live pair's count of
    rows scored again after the tensor cores' certificate (the CPU path
    leaves it as it is).

    On a CUDA device this launches the hand-written kernel, its pairs
    sorted by block on the device (``fine_binmax_pairs``) where Q > 1; on
    the CPU it runs the plain version."""
    if E_c3.device.type == "cpu":
        return fine_binmax_reference(E_c3, scales3, q, blk, vcnt)
    mode = _check_fine_operands(E_c3, scales3, blk, vcnt, "fine_binmax")
    nblocks, _, d = E_c3.shape
    Q, L = blk.shape
    qb, blk, vcnt, sc = _kernel_operands(E_c3, scales3, q, blk, vcnt, mode)
    if qb.data_ptr() % 16:  # the kernel copies the queries 16 bytes at a time
        qb = qb.clone()
    out = torch.empty((Q, L), dtype=torch.float32, device=E_c3.device)
    if Q == 0 or L == 0:
        return out
    if cand_counts is not None and (cand_counts.shape != (Q, L)
                                    or cand_counts.dtype != torch.int32
                                    or not cand_counts.is_contiguous()):
        raise ValueError(f"fine_binmax: cand_counts must be a contiguous ({Q}, {L}) int32 tensor")
    keys, perm = fine_binmax_pairs(blk, vcnt, nblocks)
    kernels.launch(
        "fine_binmax", E_c3.data_ptr(), _MODE_IDS[mode], sc.data_ptr(), qb.data_ptr(),
        blk.data_ptr(), vcnt.data_ptr(), None if keys is None else keys.data_ptr(),
        0 if keys is None else keys.element_size(), None if perm is None else perm.data_ptr(),
        1 if keys is None else pair_window(Q * L, _sm_count(E_c3.device)), Q * L, L, nblocks,
        d, out.data_ptr(),
        None if cand_counts is None else cand_counts.data_ptr(),
        torch.cuda.current_stream(E_c3.device).cuda_stream)
    return out


def fine_topk_reference(E_c3, scales3, q, blk, vcnt, k: int):
    """Plain PyTorch version of ``fine_topk``: the top-k candidate slots
    by (score desc, slot asc) -> (vals (Q, k) f32, slots (Q, k) int32,
    -1 where -inf)."""
    Q, L = blk.shape
    flat = fine_scores_reference(E_c3, scales3, q, blk, vcnt)
    sid = (blk.long()[:, :, None] * SLAB
           + torch.arange(SLAB, device=blk.device)).reshape(Q, L * SLAB)
    n = L * SLAB
    if n < k:
        flat = torch.nn.functional.pad(flat, (0, k - n), value=_NEG_INF)
        sid = torch.nn.functional.pad(sid, (0, k - n), value=-1)
    vals, slots = _select_topk(flat, sid.to(torch.int32), k)
    return vals, torch.where(torch.isfinite(vals), slots, -1)


# ring stages of the fine_topk kernel's launch configurations
# (kernels/fine_topk.cu ``dispatch``), and the pairs its tensor-core tile
# scores at a time
_FINE_STAGES = (6, 2)
_FINE_COLS = 8


def fine_topk_keys(k: int):
    """(KP, T): a query's best-key slots (the next power of two >= k) and
    its key buffer: up to 32 keys the kernel selects by warp minima and
    keeps no candidates; above, room for at least one slab's candidates."""
    kp = 1 << max(k - 1, 0).bit_length()
    return (kp, kp) if kp <= 32 else (kp, max(2 * kp, 512))


def fine_topk_smem(cfg: int, d: int, mode: str, qb: int, k: int) -> int:
    """Shared-memory bytes of a ``fine_topk`` CTA: the slab ring (a k-step
    is a TMA box of the stored rows x 64 bytes, with its mbarrier), the
    tile's queries (bf16, padded by 16 bytes), the score tile and its
    error-bound tile, each warp's f32 query and survivor list, the key
    buffers, the counts and the column table."""
    stored = SLAB // 2 if mode == "int4" else SLAB
    ring = _FINE_STAGES[cfg] * (stored * 64 + 16)
    dpad = _cdiv(d, 64) * 64
    _, T = fine_topk_keys(k)
    return (ring + qb * (dpad + 8) * 2 + 2 * _FINE_COLS * (SLAB + 4) * 4
            + 8 * (dpad + SLAB) * 4 + qb * T * 8 + qb * 4 + _FINE_COLS * 8)


def fine_topk_plan(Q: int, L: int, k: int, d: int, mode: str, sms: int):
    """The ``fine_topk`` kernel's launch plan -> (cfg, QB, G).

    QB queries a tile share each slab they probe: up to 32, as many as
    their key buffers leave room for beside a six-stage ring, else
    beside a two-stage ring (the largest k).  A slab's pairs are scored
    8 at a time (an item rarely has more: 4.3 on average at the smoke's
    nprobe 512, 1.5 at its int4 call).  G CTAs a tile, so that about one
    CTA lands on each SM, with at least 4 of the tile's list slots each,
    and at most ``_FINE_MERGE_KEYS`` partial keys per query for the merge
    (G = 1: no merge)."""
    Q = max(Q, 1)
    for cfg in range(len(_FINE_STAGES)):
        fixed = fine_topk_smem(cfg, d, mode, 0, k)
        per_q = fine_topk_smem(cfg, d, mode, 1, k) - fixed
        qb = min(32, Q, (kernels.SMEM_BYTES - fixed) // per_q)
        if qb >= min(8, Q):
            break
    if qb < 1:
        raise ValueError(f"fine_topk: k={k} at d={d} does not fit shared memory")
    kp, _ = fine_topk_keys(k)
    G = min(_cdiv(sms, _cdiv(Q, qb)), _cdiv(qb * L, 4), max(_FINE_MERGE_KEYS // kp, 1))
    return cfg, qb, max(G, 1)


def fine_pair_keys(blk, vcnt, QB: int, nblocks: int):
    """The fine kernels' pair table (``fine_topk``'s, and ``fine_scores``'
    with one tile, QB = Q), built on the device with no
    host synchronisation: every (query, list slot) pair keyed (query
    tile) (nblocks + 1) + blk, a dead slot (vcnt <= 0) keyed ``nblocks``
    past its tile's base, and sorted, so a run of equal keys is one block
    and the live pairs of the tile that list it -> (sorted keys (Q L,)
    int64, their flat positions in (Q, L) int64)."""
    Q, L = blk.shape
    b = torch.where(vcnt.reshape(-1) > 0, blk.reshape(-1), nblocks)
    if Q > QB:
        pos = torch.arange(Q * L, device=blk.device)
        b = b + (pos // (L * QB)) * (nblocks + 1)
    top = (_cdiv(Q, QB) - 1) * (nblocks + 1) + nblocks
    keys, perm = torch.sort(b.to(narrowest_int(top)), stable=True)
    return keys.long(), perm


def fine_call(E_c3, scales3, q, blk, vcnt, k: int):
    """The selecting fine stage: per query, the running top-k over its L
    slabs -> (vals (Q, k) f32, slots (Q, k) int32, -1 where -inf), ties
    to the lowest slot id.

    On a CUDA device this launches the hand-written kernel; on the CPU
    it runs the plain version."""
    if E_c3.device.type == "cpu":
        return fine_topk_reference(E_c3, scales3, q, blk, vcnt, k)
    mode = _check_fine_operands(E_c3, scales3, blk, vcnt, "fine_topk")
    if not 1 <= k <= _FINE_TOPK_MAX_K:
        raise ValueError(f"fine_topk supports 1 <= k <= {_FINE_TOPK_MAX_K}; got k={k}")
    nblocks, _, d = E_c3.shape
    Q, L = blk.shape
    dev = E_c3.device
    qb, blk, vcnt, sc = _kernel_operands(E_c3, scales3, q, blk, vcnt, mode)
    if qb.data_ptr() % 16:  # the kernel reads the queries 16 bytes at a time
        qb = qb.clone()
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    slots = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return vals, slots
    cfg, QB, G = fine_topk_plan(Q, L, k, d, mode, _sm_count(dev))
    keys, perm = fine_pair_keys(blk, vcnt, QB, nblocks)
    pvc = vcnt.reshape(-1)[perm]  # each sorted pair's vcnt
    part = torch.empty((Q, G, k) if G > 1 else (0,), dtype=torch.int64, device=dev)
    kernels.launch(
        "fine_topk", E_c3.data_ptr(), _MODE_IDS[mode], sc.data_ptr(), qb.data_ptr(),
        keys.data_ptr(), perm.data_ptr(), pvc.data_ptr(), Q * L, L, nblocks, Q, d, k, cfg,
        QB, G, part.data_ptr(), vals.data_ptr(), slots.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    return vals, slots


def auto_u(L: int) -> int:
    """Slabs per grid step of the TPU fine kernels: 8 when that adds no
    padding over 4.  Kept because L is rounded up to a multiple of it,
    which sets the dump decision and the positional tie order."""
    if -(-L // 8) * 8 == -(-L // 4) * 4:
        return 8
    return 4


def _use_dump(Q: int, L: int) -> bool:
    """The score-dump path while its (Q, L * SLAB) f32 buffer is under
    ``_DUMP_MAX_BYTES`` and one query's row under ``_DUMP_VMEM_BYTES``."""
    return (Q * L * SLAB * 4 <= _DUMP_MAX_BYTES
            and L * SLAB * 4 <= _DUMP_VMEM_BYTES)


def fine_call_xla(E_c3, scales3, q, blk, vcnt, k: int, bias=None):
    """Fine stage with the selection outside the kernel: blocks sorted
    ascending (dead slots last), every candidate's score dumped by
    ``fine_scores``, one positional top-k, so the lowest position is the
    lowest slot id (the selecting kernel's tie order).

    ``bias`` (Q, L) f32 adds a per-slot term to every row score of that
    slot after the dump: the int4 residual copy's exact q . centroid part
    (a dead slot stays -inf)."""
    Q, L = blk.shape
    key = torch.where(vcnt > 0, blk, 2**30)
    order = torch.argsort(key, dim=1, stable=True)
    blk2 = torch.gather(blk, 1, order)
    vc2 = torch.gather(vcnt, 1, order)
    flat = fine_scores_call(E_c3, scales3, q, blk2, vc2)
    if bias is not None:
        bias2 = torch.gather(bias, 1, order)
        flat = (flat.view(Q, L, SLAB) + bias2[:, :, None]).view(Q, L * SLAB)
    kk = min(k, L * SLAB)
    vals, pos = stable_topk(flat, kk)
    slots = torch.gather(blk2.long(), 1, pos // SLAB) * SLAB + pos % SLAB
    slots = torch.where(torch.isfinite(vals), slots, -1).to(torch.int32)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=_NEG_INF)
        slots = torch.nn.functional.pad(slots, (0, k - kk), value=-1)
    return vals, slots


def fine_call_auto(E_c3, scales3, q, blk, vcnt, k: int, bias=None):
    """The JAX package's fine-stage dispatch: the score dump while
    ``_use_dump`` holds, else the selecting kernel.  Candidate ids are the
    same on both paths; values differ by summation order.  A ``bias``
    (the int4 copy's q . centroid term) needs the dump path and is
    refused past its limits."""
    Q, L = blk.shape
    if bias is not None and not _use_dump(Q, L):
        raise ValueError(
            f"int4 fine stage needs the score-dump path, but Q={Q} L={L} "
            f"exceeds its buffer budget ({Q}x{L}x{SLAB} f32 scores; caps "
            f"{_DUMP_MAX_BYTES >> 20} MiB total / {_DUMP_VMEM_BYTES >> 20}"
            f" MiB per query). Lower nprobe or use ivf_fine_dtype='int8'.")
    if _use_dump(Q, L):
        return fine_call_xla(E_c3, scales3, q, blk, vcnt, k, bias=bias)
    return fine_call(E_c3, scales3, q, blk, vcnt, k)


# ---------------------------------------------------------------------------
# search core
def block_lists(probes, blk_start, nblk, counts, L: int, return_clusters: bool = False):
    """Per-query candidate block lists: probes (Q, P) cluster ids ->
    (blk (Q, L) block ids, vcnt (Q, L) valid rows per block); slots past
    the probed clusters' blocks point at block 0 with vcnt 0.  With
    ``return_clusters`` also the per-slot cluster ids (Q, L), through
    which the int4 path gathers its per-slot q . centroid bias."""
    Q, P = probes.shape
    probes = probes.long()
    nb_p = nblk[probes].long()  # (Q, P)
    cum = torch.cumsum(nb_p, dim=1)
    starts = cum - nb_p
    total = cum[:, -1:]
    j = torch.arange(L, device=probes.device)[None, :].expand(Q, L).contiguous()
    seg = torch.searchsorted(cum.contiguous(), j, right=True)  # cum entries <= j
    segc = torch.clamp(seg, max=P - 1)
    probe_c = torch.gather(probes, 1, segc)
    off = j - torch.gather(starts, 1, segc)
    blk = blk_start[probe_c].long() + off
    vcnt = torch.clamp(counts[probe_c].long() - off * SLAB, 0, SLAB)
    live = j < total
    out = (torch.where(live, blk, 0).to(torch.int32),
           torch.where(live, vcnt, 0).to(torch.int32))
    if return_clusters:
        return out + (probe_c.to(torch.int32),)
    return out


def _tail_scores(E_master, q, base: int, tail_max: int):
    """(Q, tail_max) f32 scores of the master window [base, base +
    tail_max): true f32 on an f32 master; on a bf16 master q rounded to
    bf16, products exact, sums in f32, the window upcast a chunk at a
    time (never a bf16 matmul, which would round the output)."""
    win = E_master[base:base + tail_max]
    if E_master.dtype == torch.float32:
        return q @ win.T
    qb = q.to(torch.bfloat16).float()
    out = torch.empty((q.shape[0], tail_max), dtype=torch.float32, device=q.device)
    for s in range(0, tail_max, _TAIL_CHUNK_ROWS):
        out[:, s:s + _TAIL_CHUNK_ROWS] = qb @ win[s:s + _TAIL_CHUNK_ROWS].float().T
    return out


def ivf2_search_core(E_master, E_c3, scales3, perm, centroids, blk_start, nblk, counts,
                     built: int, count: int, q, *, k: int, nprobe: int, L: int,
                     tail_max: int, refine_extra: Optional[int] = None):
    """q (Q, d) f32 -> (vals (Q, k) f32, rows (Q, k) int32 global ids).

    Rows [0, built) are served by the clustered fine stage, rows [built,
    count) by an exact scan of a ``tail_max``-wide window of the master.
    The fine stage over-selects ``k + refine_extra`` candidates (default
    2k; with an int4 copy max(10k, a twelfth of the probed pool), whose
    rescore gather is refused past ``_RESCORE_MAX_BYTES``); every
    candidate is rescored on the master, so returned scores are
    master-exact and recall is bounded by nprobe coverage only.  Ties go
    to the smallest global id."""
    Q, d = q.shape
    q = q.float()
    int4 = _fine_mode(E_c3) == "int4"
    if refine_extra is None:
        # 4-bit residual ranking drops a roughly constant share of the true
        # top-k below a fixed percentile of the pool, so the int4 default
        # grows with the pool (L * SLAB), not with k
        refine_extra = max(10 * k, (L * SLAB) // 12) if int4 else k
        gather = Q * min(k + refine_extra, L * SLAB) * d * 4
        if gather > _RESCORE_MAX_BYTES:
            raise ValueError(
                f"int4 master rescore would gather {gather >> 20} MiB "
                f"(Q={Q}, pool={L * SLAB}, refine_extra={refine_extra}); "
                f"cap is {_RESCORE_MAX_BYTES >> 20} MiB. Lower nprobe, "
                f"split the query batch, use ivf_fine_dtype='int8', or "
                f"pass refine_extra explicitly.")
    cand_i = []
    if L > 0:
        cs = q @ centroids.T
        _, probes = stable_topk(cs, nprobe)
        if int4:
            # fine scores are q . (row - centroid): add the exact
            # q . centroid of each slot's cluster from the coarse table
            blk, vcnt, pc = block_lists(probes, blk_start, nblk, counts, L,
                                        return_clusters=True)
            bias = torch.gather(cs, 1, pc.long())
        else:
            blk, vcnt = block_lists(probes, blk_start, nblk, counts, L)
            bias = None
        kf = min(k + refine_extra, L * SLAB)
        _, fslots = fine_call_auto(E_c3, scales3, q, blk, vcnt, kf, bias=bias)
        fgids = perm[torch.clamp(fslots, min=0).long()]
        fgids = torch.where(fslots >= 0, fgids, -1)
        # a built row may have been deleted (zeroed): it stays, and the
        # engine's tombstone filter drops it, as on the exact tiers
        cand_i.append(torch.where(fgids >= 0, fgids, _BIG_I32))
    tail_v = tail_i = None
    if tail_max > 0:
        base = min(max(built, 0), max(E_master.shape[0] - tail_max, 0))
        ts = _tail_scores(E_master, q, base, tail_max)
        gid = base + torch.arange(tail_max, device=q.device)
        live = (gid >= built) & (gid < count)
        ts = torch.where(live[None, :], ts, _NEG_INF)
        tv, tloc = stable_topk(ts, min(k, tail_max))
        tail_v = tv
        tail_i = torch.where(torch.isfinite(tv), gid[tloc], _BIG_I32).to(torch.int32)
        cand_i.append(tail_i)
    if not cand_i:
        return (torch.full((Q, k), _NEG_INF, device=q.device),
                torch.full((Q, k), -1, dtype=torch.int32, device=q.device))
    if L == 0:  # tail only: scores are already master-exact
        vals, ids = _select_topk(tail_v, tail_i, min(k, tail_v.shape[1]))
    else:
        ids_all = torch.cat([c.to(torch.int32) for c in cand_i], dim=1)
        safe = torch.clamp(ids_all, 0, E_master.shape[0] - 1).long()
        rows = E_master[safe].float()  # (Q, c, d)
        # q rounded to the master dtype: the exact tiers' convention
        q_r = _round_to_dtype_f32(q, E_master.dtype)
        scores = torch.where(ids_all < count, _rescore(q_r, rows), _NEG_INF)
        vals, ids = _select_topk(scores, ids_all, k)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=_NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, pad), value=_BIG_I32)
    return vals, torch.where(torch.isfinite(vals), ids, -1).to(torch.int32)
