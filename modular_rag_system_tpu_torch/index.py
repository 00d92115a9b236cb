"""DeviceIndex — a growable device-resident embedding matrix.

Embeddings live on the device as one (capacity, d) matrix: an append is
an in-place slice write, capacity grows by powers of two, and search
dispatches to the configured tier.  Row ids are dense append order and
match ``DocumentStore.row_idx``.

Tiers: "exact" (true-f32 matmul + stable top-k); "fused" (the f32/bf16
kernels over the master: ``binmax`` two-pass, or the single-pass
``fused_topk`` below 8192 rows of capacity); "bf16" (the same over a
bf16 copy of an f32 master); "int8" (the int8 copy searched by the int8
kernels, scores rescored on the master); "ivf" (``ops/ivf2.py``: the
clustered fine stage plus an exact tail, rebuilt from the write path;
before its first build, and at k > 64, it serves the fused route) and
"auto" (int8 below 4,194,304 rows, ivf at and above).

Both index kinds (this one and ``parallel/sharded.py``'s) serve one
interface (``_SearchFront``): ``search_device`` on device tensors,
``search`` and ``search_deep`` on numpy, ``ivf_stats`` and
``empty_like``; each chooses its own route under its own lock.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from modular_rag_system_tpu_torch.ops import exact as exact_ops
from modular_rag_system_tpu_torch.ops.binmax_topk import (
    _MIN_TWOPASS_CAP,
    auto_bin_width,
    int8_refine_kf,
    refine_against_master,
    twopass_topk_int8_master_raw,
    twopass_topk_raw,
)
from modular_rag_system_tpu_torch.ops.fused_topk import (
    _check_bin_width,
    fused_topk_int8_raw,
    fused_topk_raw,
)
from modular_rag_system_tpu_torch.ops.quantize import quantize_rows
from modular_rag_system_tpu_torch.utils.device import resolve_device

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TIERS = ("exact", "fused", "bf16", "int8", "ivf", "auto")
# the ivf tier's fine stage serves k up to this; deeper k (filtered
# refills) takes the fused route (a sharded index: exact per shard)
_IVF_MAX_K = 64
# rows per host -> device copy of an append
_ADD_CHUNK_ROWS = 1 << 20


def snapshot_embeddings(data) -> np.ndarray:
    """Decode a snapshot's embedding matrix (f32, or bf16 stored as its
    uint16 bits) as f32."""
    if "embeddings_bf16" in data:
        bits = data["embeddings_bf16"].astype(np.uint32) << 16
        return bits.view(np.float32)
    return data["embeddings"]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# every index knob (attribute names match the IndexConfig fields 1:1, as
# in the JAX package)
_INDEX_TIER_KEYS = (
    "tier", "block_rows", "fused_bin_width", "store_dtype",
    "ivf_clusters", "ivf_nprobe", "ivf_iters", "ivf_fine_dtype",
    "ivf_tail_frac", "ivf_rebuild_min", "ivf_refine_extra", "ivf_balance",
)


def _index_tier_kwargs(src) -> Dict[str, Any]:
    """Constructor kwargs of an index's knobs, from a config or an index."""
    return {key: getattr(src, key) for key in _INDEX_TIER_KEYS}


def _no_rows(q: torch.Tensor):
    """(Q, 0) results on q's device."""
    return (torch.empty((q.shape[0], 0), dtype=torch.float32, device=q.device),
            torch.empty((q.shape[0], 0), dtype=torch.int32, device=q.device))


def _pad_absent(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """(Q, k') results padded to k columns of absent rows (-inf, -1)."""
    pad = k - vals.shape[1]
    if pad <= 0:
        return vals, rows
    return (torch.nn.functional.pad(vals, (0, pad), value=float("-inf")),
            torch.nn.functional.pad(rows, (0, pad), value=-1))


class _SearchFront:
    """The search interface of both index kinds (``DeviceIndex`` and
    ``parallel/sharded.py``'s ``ShardedIndex``), over their own
    ``_search_device(q, k, deep)``, which takes the index's lock and
    chooses the route.  Each returns (Q, k) results, -inf and -1 where
    fewer than k rows exist: ties go to the smallest row id, and rows at
    or past ``count`` never score."""

    def search_device(self, q: torch.Tensor, k: int):
        """Top-k of (Q, d) f32 queries on the index's device -> (vals f32,
        rows) device tensors, through the tier's route (``auto`` resolved
        on ``count``; the ivf tier before its first build and at k > 64
        serves its fallback)."""
        return self._search_device(q, k, deep=False)

    def search(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``search_device`` for numpy queries -> numpy (scores, rows)."""
        return self._on_host(q, k, deep=False)

    def search_deep(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The exact top-k over the master in true f32, at any k up to
        ``count`` (the engine's deep filtered refill); numpy in and out."""
        return self._on_host(q, k, deep=True)

    def _on_host(self, q, k: int, deep: bool):
        qt = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        vals, rows = self._search_device(qt, k, deep)
        return vals.cpu().numpy(), rows.cpu().numpy()

    def ivf_stats(self) -> Optional[Dict[str, Any]]:
        """The ivf structure's state (None before a build): clustered vs
        exact-tail rows, drift since the build, rebuilds, fine-copy bytes."""
        with self._lock:
            iv = self._ivf2
            if iv is None:
                return None
            return {
                "fine_dtype": iv.fine_dtype,
                "clusters": iv.n_clusters,
                "built": iv.built,
                "tail_rows": max(self.count - iv.built, 0),
                "stale_rows": iv.stale_rows,
                "rebuilds": self.ivf_rebuilds,
                "fine_bytes": iv.fine_bytes(),
            }

    def _maybe_build_ivf2(self) -> None:
        """Write-path rebuild trigger: (re)cluster when the exact tail +
        stale rows reach max(ivf_rebuild_min, ivf_tail_frac * count).
        Queries never rebuild."""
        if self.effective_tier() != "ivf" or self.count == 0:
            return
        built = self._ivf2.built if self._ivf2 else 0
        stale = self._ivf2.stale_rows if self._ivf2 else 0
        pending = self.count - built + stale
        if pending >= max(self.ivf_rebuild_min, int(self.ivf_tail_frac * self.count)):
            self.build_ann()


class DeviceIndex(_SearchFront):
    """Single-device index on ``device`` (default "cuda")."""

    # tier="auto" serves int8 below this many rows and ivf at or above it;
    # the same crossover switches the auto fine copy from bf16 to int8
    _AUTO_IVF_ROWS = 4_194_304
    _IVF_AUTO_INT8_ROWS = _AUTO_IVF_ROWS

    def __init__(
        self,
        dim: int,
        capacity: int = 4096,
        tier: str = "exact",
        block_rows: int = 1024,
        ivf_clusters: Optional[int] = None,
        ivf_nprobe: int = 8,
        ivf_iters: int = 10,
        fused_bin_width: Optional[int] = None,
        store_dtype: str = "float32",
        ivf_fine_dtype: str = "auto",
        ivf_tail_frac: float = 0.25,
        ivf_rebuild_min: int = 32768,
        ivf_refine_extra: Optional[int] = None,
        ivf_balance: float = 0.0,
        device="cuda",
    ) -> None:
        from modular_rag_system_tpu_torch.ops.ivf2 import check_fine_dtype

        if tier not in _TIERS:
            raise ValueError(f"unknown index tier {tier!r}")
        if store_dtype not in _TORCH_DTYPES:
            raise ValueError(f"store_dtype must be float32|bfloat16, got {store_dtype}")
        if tier in ("ivf", "auto"):
            check_fine_dtype(ivf_fine_dtype)
        self.device = resolve_device(device)
        self.dim = dim
        self.tier = tier
        self.block_rows = block_rows
        self.fused_bin_width = fused_bin_width
        self.store_dtype = store_dtype
        self._dtype = _TORCH_DTYPES[store_dtype]
        self.capacity = _next_pow2(max(capacity, 1024))
        self.count = 0
        self._lock = threading.RLock()
        # write gate: held by every writer and across build_ann's k-means
        # and fill, which read E without _lock.  Writers are excluded
        # (an append writes E in place, a growth replaces it); readers
        # keep serving the old structure and the exact tail.  Lock order:
        # _build_gate -> _lock.
        self._build_gate = threading.RLock()
        self.E = torch.zeros((self.capacity, dim), dtype=self._dtype, device=self.device)
        # derived copies: when not None they are in sync with E (writes
        # update them incrementally); capacity growth drops them for a
        # lazy full rebuild at the next search that needs them
        self._E_q: Optional[torch.Tensor] = None  # (capacity, d) int8
        self._scales: Optional[torch.Tensor] = None  # (capacity, 1) f32
        self._E_bf16: Optional[torch.Tensor] = None  # (capacity, d) bf16
        # ivf tier state: appended rows live in the exact tail until the
        # write path rebuilds (tail + stale rows past the threshold)
        self.ivf_clusters = ivf_clusters
        self.ivf_nprobe = ivf_nprobe
        self.ivf_iters = ivf_iters
        self.ivf_fine_dtype = ivf_fine_dtype
        self.ivf_tail_frac = ivf_tail_frac
        self.ivf_rebuild_min = ivf_rebuild_min
        self.ivf_refine_extra = ivf_refine_extra
        self.ivf_balance = ivf_balance
        # pending (centroids, labels) warm start, consumed by the next build
        self.ivf_warmstart = None
        self.ivf_rebuilds = 0
        # wall seconds of the last build (k-means + splits + fill)
        self.ivf_last_build_s = 0.0
        self._ivf2 = None

    # ------------------------------------------------------------------
    def add(self, mat) -> Tuple[int, int]:
        """Append (n, d) rows (numpy or a tensor); returns (first_row, n)."""
        n = int(mat.shape[0])
        if n == 0:
            return self.count, 0
        if mat.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {mat.shape[1]} != {self.dim}")
        with self._build_gate:
            with self._lock:
                first = self.count
                # capacity follows the JAX index's pow-2 padded batches,
                # so the search route takes the same growth steps; rows
                # past count are zero already, so only n rows are written
                self._ensure_capacity(self.count + _next_pow2(n))
                src = torch.as_tensor(mat)
                for s in range(0, n, _ADD_CHUNK_ROWS):
                    x = src[s:s + _ADD_CHUNK_ROWS].to(self.device, torch.float32)
                    self._append(x.to(self._dtype), first + s)
                self.count += n
            # threshold rebuild outside _lock (gate still held): queries
            # keep serving the old structure + exact tail during the build
            self._maybe_build_ivf2()
        return first, n

    def _append(self, x: torch.Tensor, start: int) -> None:
        """Write store-dtype rows at ``start`` into E and the derived copies."""
        exact_ops.append_rows(self.E, x, start)
        if self._E_q is not None:
            qv, sc = quantize_rows(x)
            exact_ops.append_rows(self._E_q, qv, start)
            exact_ops.append_rows(self._scales, sc, start)
        if self._E_bf16 is not None:
            exact_ops.append_rows(self._E_bf16, x, start)

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = _next_pow2(needed)
        E = torch.zeros((new_cap, self.dim), dtype=self._dtype, device=self.device)
        E[: self.capacity] = self.E
        self.E = E
        self.capacity = new_cap
        # the ivf structure survives growth: its fine copy and perm do
        # not depend on E's capacity, inv_perm covers the built prefix
        self._E_q = self._scales = self._E_bf16 = None

    def delete_rows(self, rows: np.ndarray) -> None:
        """Zero deleted rows in E, the derived copies and the fine copy."""
        if len(rows) == 0:
            return
        with self._build_gate:
            with self._lock:
                r = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
                for t in (self.E, self._E_q, self._scales, self._E_bf16):
                    if t is not None:
                        exact_ops.zero_rows(t, r)
                if self._ivf2 is not None:
                    self._ivf2.update_rows(rows, None)
            # rewrites count as drift: without this an update-only
            # workload would never rebuild
            self._maybe_build_ivf2()

    def set_rows(self, rows: np.ndarray, mat) -> None:
        """Overwrite existing rows (e.g. re-ingest of a deleted doc)."""
        if len(rows) == 0:
            return
        with self._build_gate:
            with self._lock:
                r = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
                # through the store dtype, so the derived copies see E's values
                m = torch.as_tensor(mat).to(self.device, torch.float32).to(self._dtype)
                exact_ops.set_rows(self.E, r, m)
                if self._E_q is not None:
                    qv, sc = quantize_rows(m)
                    exact_ops.set_rows(self._E_q, r, qv)
                    exact_ops.set_rows(self._scales, r, sc)
                if self._E_bf16 is not None:
                    exact_ops.set_rows(self._E_bf16, r, m)
                if self._ivf2 is not None:
                    # the row keeps its old cluster until the next rebuild
                    self._ivf2.update_rows(rows, mat)
            self._maybe_build_ivf2()

    # ------------------------------------------------------------------
    # search (search_device, search, search_deep: _SearchFront)
    def effective_tier(self) -> str:
        """``tier="auto"``: int8 below ``_AUTO_IVF_ROWS``, ivf at or above
        (a property of ``count``; the write path builds the structure)."""
        if self.tier != "auto":
            return self.tier
        return "ivf" if self.count >= self._AUTO_IVF_ROWS else "int8"

    def _effective_tier(self, k: int) -> str:
        """The route that serves k: before its first build, and at
        deep-refill k, the ivf tier serves the fused route."""
        tier = self.effective_tier()
        if tier == "ivf" and (self._ivf2 is None or k > _IVF_MAX_K):
            return "fused"
        return tier

    def _operands(self, tier: str) -> Tuple:
        """(rows, scales, master) of a streaming tier (hold _lock): the
        int8 copy with its scales and the master for the rescore, the
        bf16 copy, or the master; a derived copy is built at first use."""
        if tier == "int8":
            if self._E_q is None:
                self._E_q, self._scales = quantize_rows(self.E)
            return self._E_q, self._scales, self.E
        if tier == "bf16" and self.store_dtype != "bfloat16":
            if self._E_bf16 is None:
                self._E_bf16 = self.E.to(torch.bfloat16)
            return self._E_bf16, None, None
        return self.E, None, None

    def _ivf_tail_max(self) -> int:
        tail = self.count - self._ivf2.built
        return 0 if tail <= 0 else min(max(8192, _next_pow2(tail)), self.capacity)

    def _ivf_search(self, q: torch.Tensor, k: int):
        from modular_rag_system_tpu_torch.ops import ivf2 as ivf2_ops

        iv = self._ivf2
        nprobe = min(self.ivf_nprobe, iv.n_clusters)
        L = iv.slots_for_nprobe(nprobe)
        # L rounded up to a multiple of the TPU kernels' U, as in JAX: it
        # sets the dump decision and the positional tie order
        U = ivf2_ops.auto_u(L)
        L = ((L + U - 1) // U) * U
        return ivf2_ops.ivf2_search_core(
            self.E, iv.E_c3, iv.scales3, iv.perm, iv.centroids, iv.blk_start, iv.nblk,
            iv.counts, iv.built, self.count, q, k=k, nprobe=nprobe, L=L,
            tail_max=self._ivf_tail_max(), refine_extra=self.ivf_refine_extra)

    def _search_device(self, q: torch.Tensor, k: int, deep: bool):
        with self._lock:
            k_eff = min(k, self.count)
            tier = "exact" if deep else self._effective_tier(k_eff)
            if k_eff == 0:
                vals, rows = _no_rows(q)
            elif tier == "exact":
                vals, rows = exact_ops.exact_topk_raw(self.E, self.count, q, k_eff)
            elif tier == "ivf":
                vals, rows = self._ivf_search(q, k_eff)
            else:
                vals, rows = stream_search_core(*self._operands(tier), self.count, q, k_eff,
                                                self.fused_bin_width, self.block_rows)
        return _pad_absent(vals, rows, k)

    def empty_like(self, capacity: int) -> "DeviceIndex":
        """A fresh, empty index of this one's device and knobs, with room
        for ``capacity`` rows (at least 4096)."""
        return DeviceIndex(dim=self.dim, capacity=max(capacity, 4096), device=self.device,
                           **_index_tier_kwargs(self))

    # ------------------------------------------------------------------
    # ivf tier: clustered fine stage + exact tail, rebuilt on writes
    def build_ann(self) -> None:
        """(Re)build the clustered structure over the current corpus.

        A pending ``ivf_warmstart`` (a snapshot's centroids + labels) is
        consumed once: the build skips k-means and fills directly; its
        labeled rows become the built prefix and any later rows stay in
        the exact tail until the threshold rebuild."""
        from modular_rag_system_tpu_torch.ops.ivf2 import IVF2

        with self._build_gate:
            # a consistent view under the state lock, then the heavy
            # k-means + fill without it: writers are excluded by the
            # gate, readers keep serving the old structure
            with self._lock:
                E, build_count = self.E, self.count
                fdt = self.ivf_fine_dtype
                if fdt == "auto":
                    fdt = "int8" if build_count > self._IVF_AUTO_INT8_ROWS else "bf16"
                warm = self.ivf_warmstart
                self.ivf_warmstart = None  # single use
                if warm is not None:
                    cents, labels = warm
                    if 0 < len(labels) <= build_count and cents.shape[1] == self.dim:
                        build_count = len(labels)
                    else:
                        warm = None
            t0 = time.perf_counter()
            new = IVF2.build(E, build_count, n_clusters=self.ivf_clusters,
                             iters=self.ivf_iters, fine_dtype=fdt,
                             balance=self.ivf_balance, warm_start=warm)
            if new.E_c3.is_cuda:
                torch.cuda.synchronize(new.E_c3.device)
            with self._lock:
                self.ivf_last_build_s = time.perf_counter() - t0
                new.version = self.ivf_rebuilds
                self._ivf2 = new
                self.ivf_rebuilds += 1

    # ------------------------------------------------------------------
    def snapshot(self, path: str) -> None:
        """Persist live rows to ``path`` (.npz, the JAX index's format); a
        built ivf structure adds its centroids and per-row labels, so a
        restore can warm-start the rebuild."""
        with self._lock:
            live = self.E[: self.count].cpu()
            extra = {}
            if self._ivf2 is not None and self._ivf2.built > 0:
                extra = {"ivf_centroids": self._ivf2.centroids.float().cpu().numpy(),
                         "ivf_labels": self._ivf2.labels_host()}
        # uncompressed: zlib on near-random mantissas saves almost nothing
        if self.store_dtype == "bfloat16":
            np.savez(path, embeddings_bf16=live.view(torch.int16).numpy().view(np.uint16),
                     count=self.count, dim=self.dim, **extra)
        else:
            np.savez(path, embeddings=live.numpy(), count=self.count, dim=self.dim,
                     **extra)

    @classmethod
    def load(cls, path: str, tier: str = "exact", device="cuda",
             **tier_kwargs) -> "DeviceIndex":
        """Rebuild an index from a ``snapshot()`` file; ``tier_kwargs``
        passes every constructor knob through, ``store_dtype`` is
        inferred from the snapshot, and saved ivf centroids + labels
        warm-start the rebuild that the append triggers."""
        data = np.load(path)
        dim = int(data["dim"])
        count = int(data["count"])
        store_dtype = "bfloat16" if "embeddings_bf16" in data else "float32"
        idx = cls(dim=dim, capacity=max(count, 4096), tier=tier,
                  store_dtype=store_dtype, device=device, **tier_kwargs)
        if "ivf_centroids" in data:
            idx.ivf_warmstart = (data["ivf_centroids"], data["ivf_labels"])
        try:
            if count:
                idx.add(snapshot_embeddings(data)[:count])
        finally:
            idx.ivf_warmstart = None  # never survives a failed restore
        return idx

    def memory_bytes(self) -> int:
        """Device bytes of the master, the derived copies and the ivf
        structure."""
        b = self.capacity * self.dim * self.E.element_size()
        if self._E_q is not None:
            b += self.capacity * self.dim + self.capacity * 4
        if self._E_bf16 is not None:
            b += self.capacity * self.dim * 2
        if self._ivf2 is not None:
            b += self._ivf2.memory_bytes()
        return b


def stream_search_core(E, scales, master, count: int, q, k: int,
                       bin_width: Optional[int], block_rows: int = 1024):
    """The streaming tiers' kernel choice.  ``scales`` given selects the
    int8 kernels (E is then the int8 copy, ``master`` the matrix the
    scores are rescored on); otherwise E holds f32 or bf16 rows.

    With no ``bin_width``, from ``_MIN_TWOPASS_CAP`` rows of capacity and
    at most cap/bw - 1 results, the two-pass search (``binmax_int8`` or
    ``binmax`` pass 1); otherwise the single-pass kernel
    (``fused_topk_int8``, over-selecting ``int8_refine_kf`` candidates
    rescored on the master, or ``fused_topk``)."""
    cap = E.shape[0]
    bw = auto_bin_width(cap)
    if bin_width is None and cap >= _MIN_TWOPASS_CAP and cap // bw >= k + 1:
        if scales is not None:
            return twopass_topk_int8_master_raw(E, scales, master, count, q, k, bw)
        return twopass_topk_raw(E, count, q, k, bw)
    _check_bin_width(bin_width, min(block_rows, cap))
    if scales is None:
        return fused_topk_raw(E, count, q, k, bin_width)
    kf = int8_refine_kf(k, cap)
    vals, rid = fused_topk_int8_raw(E, scales, count, q, kf, bin_width)
    if kf > k:
        vals, rid = refine_against_master(master, q, rid, k, cand_vals=vals)
    return vals, rid
