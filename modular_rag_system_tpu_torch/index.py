"""DeviceIndex — a growable device-resident embedding matrix.

Embeddings live on the device as one (capacity, d) matrix: an append is
an in-place slice write, capacity grows by powers of two, and search
dispatches to the configured tier.  Row ids are dense append order and
match ``DocumentStore.row_idx``.

Tiers served: "exact" (true-f32 matmul + stable top-k), "int8" (the int8
copy searched by the hand-written kernels, scores rescored on the master
matrix) and "auto" (int8 below 4,194,304 rows).  "fused", "bf16", "ivf"
and "auto" at or above 4,194,304 rows raise ``NotImplementedError``.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from modular_rag_system_tpu_torch.ops import exact as exact_ops
from modular_rag_system_tpu_torch.ops.binmax_topk import (
    _MIN_TWOPASS_CAP,
    auto_bin_width,
    int8_refine_kf,
    refine_against_master,
    twopass_topk_int8_master_raw,
)
from modular_rag_system_tpu_torch.ops.fused_topk import fused_topk_int8_raw
from modular_rag_system_tpu_torch.ops.quantize import quantize_rows
from modular_rag_system_tpu_torch.utils.device import resolve_device

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_UNPORTED_TIERS = {
    "fused": "the fused tier needs the f32/bf16 kernels _fused_kernel and "
             "_binmax_kernel",
    "bf16": "the bf16 tier needs the f32/bf16 kernels _fused_kernel and "
            "_binmax_kernel",
    "ivf": "the ivf tier needs IVF2 + k-means and the fine-stage kernels",
}


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


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: modules to port)")


class DeviceIndex:
    """Single-device index on ``device`` (default "cuda")."""

    # tier="auto" serves int8 below this many rows and ivf at or above it
    _AUTO_IVF_ROWS = 4_194_304

    def __init__(
        self,
        dim: int,
        capacity: int = 4096,
        tier: str = "exact",
        fused_bin_width: Optional[int] = None,
        store_dtype: str = "float32",
        device="cuda",
    ) -> None:
        if tier in _UNPORTED_TIERS:
            raise _unported(f"tier={tier!r}: {_UNPORTED_TIERS[tier]}")
        if tier not in ("exact", "int8", "auto"):
            raise ValueError(f"unknown index tier {tier!r}")
        if store_dtype not in _TORCH_DTYPES:
            raise ValueError(f"store_dtype must be float32|bfloat16, got {store_dtype}")
        self.device = resolve_device(device)
        self.dim = dim
        self.tier = tier
        self.fused_bin_width = fused_bin_width
        self.store_dtype = store_dtype
        self._dtype = _TORCH_DTYPES[store_dtype]
        self.capacity = _next_pow2(max(capacity, 1024))
        self.count = 0
        self._lock = threading.RLock()
        self.E = torch.zeros((self.capacity, dim), dtype=self._dtype, device=self.device)
        # derived int8 copy: when not None it is in sync with E (writes
        # update it incrementally); capacity growth drops it for a lazy
        # full rebuild at the next int8 search
        self._E_q: Optional[torch.Tensor] = None  # (capacity, d) int8
        self._scales: Optional[torch.Tensor] = None  # (capacity, 1) f32

    # ------------------------------------------------------------------
    def add(self, mat) -> Tuple[int, int]:
        """Append (n, d) rows (numpy or a tensor); returns (first_row, n)."""
        n = int(mat.shape[0])
        if n == 0:
            return self.count, 0
        if mat.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {mat.shape[1]} != {self.dim}")
        with self._lock:
            first = self.count
            # pow-2 padded batch, as in the JAX index: capacity (and so
            # the search route) follows the same growth steps
            padded = _next_pow2(n)
            self._ensure_capacity(self.count + padded)
            buf = torch.zeros((padded, self.dim), dtype=self._dtype, device=self.device)
            buf[:n] = torch.as_tensor(mat).to(self.device, torch.float32)
            exact_ops.append_rows(self.E, buf, self.count)
            if self._E_q is not None:
                qv, sc = quantize_rows(buf)
                exact_ops.append_rows(self._E_q, qv, self.count)
                exact_ops.append_rows(self._scales, sc, self.count)
            self.count += n
        return first, n

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = _next_pow2(needed)
        E = torch.zeros((new_cap, self.dim), dtype=self._dtype, device=self.device)
        E[: self.capacity] = self.E
        self.E = E
        self.capacity = new_cap
        self._E_q = self._scales = None

    def delete_rows(self, rows: np.ndarray) -> None:
        """Zero deleted rows; their int8 rows and scales become 0 too."""
        if len(rows) == 0:
            return
        with self._lock:
            r = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
            exact_ops.zero_rows(self.E, r)
            if self._E_q is not None:
                exact_ops.zero_rows(self._E_q, r)
                exact_ops.zero_rows(self._scales, r)

    def set_rows(self, rows: np.ndarray, mat) -> None:
        """Overwrite existing rows (e.g. re-ingest of a deleted doc)."""
        if len(rows) == 0:
            return
        with self._lock:
            r = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
            # through the store dtype, so the int8 copy sees E's values
            m = torch.as_tensor(mat).to(self.device, torch.float32).to(self._dtype)
            exact_ops.set_rows(self.E, r, m)
            if self._E_q is not None:
                qv, sc = quantize_rows(m)
                exact_ops.set_rows(self._E_q, r, qv)
                exact_ops.set_rows(self._scales, r, sc)

    # ------------------------------------------------------------------
    # search protocol (shared by search() and the engine's query path):
    #   search_ops()    tier operand tensors (hold _lock),
    #   search_core(k)  fn(ops, count, q) -> (vals, rows),
    #   search_token()  what identifies the function search_core returns
    def effective_tier(self) -> str:
        if self.tier != "auto":
            return self.tier
        if self.count >= self._AUTO_IVF_ROWS:
            raise _unported(f"tier='auto' at {self.count} rows (>= "
                            f"{self._AUTO_IVF_ROWS}) resolves to ivf, which")
        return "int8"

    def search_ops(self) -> Tuple:
        if self.effective_tier() == "int8":
            if self._E_q is None:
                self._E_q, self._scales = quantize_rows(self.E)
            # the master rides along for the rescore
            return (self._E_q, self._scales, self.E)
        return (self.E,)

    def search_token(self) -> Tuple:
        return (self.effective_tier(), self.capacity, self.fused_bin_width,
                self.store_dtype)

    def search_core(self, k: int):
        tier = self.effective_tier()
        if tier == "exact":
            def core(ops, count, q):
                return exact_ops.exact_topk_raw(ops[0], count, q, k)

            return core
        bin_width = self.fused_bin_width

        def core(ops, count, q):
            E_q, scales, E_master = ops
            return stream_search_core(E_q, scales, E_master, count, q, k, bin_width)

        return core

    # ------------------------------------------------------------------
    def search(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k rows for (Q, d) queries. Returns (scores, rows) as numpy."""
        Q = q.shape[0]
        if self.count == 0:
            return (np.full((Q, k), -np.inf, dtype=np.float32),
                    np.full((Q, k), -1, dtype=np.int32))
        k_eff = min(k, self.count)
        qt = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        with self._lock:
            scores, rows = self.search_core(k_eff)(self.search_ops(), self.count, qt)
        scores = scores.cpu().numpy()
        rows = rows.cpu().numpy()
        if k_eff < k:  # pad to requested k
            scores = np.concatenate(
                [scores, np.full((Q, k - k_eff), -np.inf, np.float32)], axis=1)
            rows = np.concatenate(
                [rows, np.full((Q, k - k_eff), -1, np.int32)], axis=1)
        return scores, rows

    # ------------------------------------------------------------------
    def snapshot(self, path: str) -> None:
        """Persist live rows to ``path`` (.npz, the JAX index's format)."""
        with self._lock:
            live = self.E[: self.count].cpu()
        # uncompressed: zlib on near-random mantissas saves almost nothing
        if self.store_dtype == "bfloat16":
            np.savez(path, embeddings_bf16=live.view(torch.int16).numpy().view(np.uint16),
                     count=self.count, dim=self.dim)
        else:
            np.savez(path, embeddings=live.numpy(), count=self.count, dim=self.dim)

    @classmethod
    def load(cls, path: str, tier: str = "exact", device="cuda",
             **tier_kwargs) -> "DeviceIndex":
        """Rebuild an index from a ``snapshot()`` file; ``store_dtype`` is
        inferred from the snapshot."""
        data = np.load(path)
        dim = int(data["dim"])
        count = int(data["count"])
        store_dtype = "bfloat16" if "embeddings_bf16" in data else "float32"
        idx = cls(dim=dim, capacity=max(count, 4096), tier=tier,
                  store_dtype=store_dtype, device=device, **tier_kwargs)
        if count:
            idx.add(snapshot_embeddings(data)[:count])
        return idx

    def memory_bytes(self) -> int:
        b = self.capacity * self.dim * self.E.element_size()
        if self._E_q is not None:
            b += self.capacity * self.dim + self.capacity * 4
        return b


def stream_search_core(E_q, scales, master, count: int, q, k: int,
                       bin_width: Optional[int]):
    """The int8 tier's kernel choice.  With no ``bin_width``, from
    ``_MIN_TWOPASS_CAP`` rows of capacity and at most cap/bw - 1 results,
    the mixed two-pass search (``binmax_int8`` pass 1, master rescan);
    otherwise the single-pass ``fused_topk_int8`` kernel over-selects
    ``kf = int8_refine_kf(k, capacity)`` candidates, rescored on the master."""
    cap = E_q.shape[0]
    bw = auto_bin_width(cap)
    if bin_width is None and cap >= _MIN_TWOPASS_CAP and cap // bw >= k + 1:
        return twopass_topk_int8_master_raw(E_q, scales, master, count, q, k, bw)
    kf = int8_refine_kf(k, cap)
    vals, rid = fused_topk_int8_raw(E_q, scales, count, q, kf, bin_width)
    if kf > k:
        vals, rid = refine_against_master(master, q, rid, k, cand_vals=vals)
    return vals, rid
