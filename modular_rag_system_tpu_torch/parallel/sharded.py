"""ShardedIndex — one index over the shards of a layout (``parallel/mesh.py``).

Layout: shard ``s`` of S owns global rows ``j * S + s`` at local row ``j``
(strided, so appends stay balanced without rebalancing).  Each shard
holds its own tensors on its own device: the master (cap_s, d), the
derived int8 and bf16 copies, and its part of the ivf structure.  A query
runs in one process:

    q on the lead device -> each shard's top-k over its local rows, on
    its device, through the same search functions (and kernels) as
    ``DeviceIndex`` -> the (Q, k) candidates, scores with global ids,
    copied to the lead device -> the global top-k by (score desc, gid asc)

Dead candidates (a shard with fewer live rows than k) carry score -inf
and id 2**31 - 1, so they lose every comparison.  Each shard's selection
keeps the lowest local row first among ties, and a shard's lowest local
row is its lowest global id, so 1 shard, S shards and a ``DeviceIndex``
return the same ids.  A hierarchical layout ((slices, chips) nested
lists) merges within each slice first, then only k candidates per slice
go across slices; the ids equal the flat layout's.

This is the single-process counterpart of the JAX package's
``parallel/sharded.py``, whose one ``shard_map`` program all-gathers the
candidates over the mesh: here the merge's copies are peer-to-peer copies
between cards, and stay on the device when the shards share one.

Across processes (``group``: a ``torch.distributed`` group, one slice of
the layout a rank, in rank order) each rank holds only its own slice's
shards: rank r's shard c is global shard ``r * P + c`` of S = W * P.
Writes follow the SPMD ingest contract: every rank runs the same call
with the same rows and writes the rows its shards own, and ``count`` is
global.  A search merges within the rank's slice, all-gathers k
candidates a rank (``parallel/multihost.all_gather_candidates``) and
merges them again, so every rank returns the same ids as one process
holding every shard.  ivf builds (the ``auto`` tier's promotion
included), ``snapshot`` and ``load`` need every row on one host and
raise, as the JAX package's multihost index does.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from modular_rag_system_tpu_torch.index import (
    _ADD_CHUNK_ROWS,
    _IVF_MAX_K,
    _TIERS,
    _TORCH_DTYPES,
    DeviceIndex,
    _index_tier_kwargs,
    _next_pow2,
    _no_rows,
    _pad_absent,
    _SearchFront,
    snapshot_embeddings,
    stream_search_core,
)
from modular_rag_system_tpu_torch.ops import exact as exact_ops
from modular_rag_system_tpu_torch.ops.fused_topk import _select_topk
from modular_rag_system_tpu_torch.ops.quantize import quantize_rows
from modular_rag_system_tpu_torch.parallel.mesh import make_index_mesh
from modular_rag_system_tpu_torch.parallel.multihost import all_gather_candidates, group_size
from modular_rag_system_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_BIG_I32 = 2**31 - 1
_NEG_INF = float("-inf")


def _count_s(count: int, s: int, S: int) -> int:
    """Live rows of shard ``s``: global rows below ``count`` that it owns."""
    return max(0, (count - s + S - 1) // S)


def _on(dev: torch.device):
    """The current-device guard of a shard's kernel launches."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _refuse_across_processes(what: str) -> None:
    raise RuntimeError(
        f"ShardedIndex across processes cannot {what}: each rank holds only its own "
        f"slice of the rows, and this needs every row on one host (the JAX package's "
        f"multihost index raises here too: it cannot fetch a global array that spans "
        f"another process's devices).  Across processes the index serves add, delete "
        f"and search under the SPMD ingest contract")


def _merge(vals, gids, k: int, device):
    """The global top-k of per-shard (Q, kk) candidates, copied to
    ``device`` and concatenated in shard order, by (score desc, gid asc):
    the merge of every sharded search path, valid at any k."""
    cv = torch.cat([v.to(device) for v in vals], dim=1)
    cg = torch.cat([g.to(device) for g in gids], dim=1)
    return _select_topk(cv, cg, k)


class ShardedIndex(_SearchFront):
    """``DeviceIndex``'s tiers and search interface over S shards.

    ``mesh`` is a flat list of the shards' devices, or (slices, chips)
    nested lists for the two-level merge (``parallel/mesh.py``); None
    takes every visible card of ``device``'s type.  The lead device
    (``device``, default the first shard's) holds the merged results.
    With ``group`` (a process group of W ranks), ``mesh`` is this rank's
    slice (a flat list) of a W-slice layout."""

    def __init__(
        self,
        dim: int,
        mesh: Optional[list] = None,
        capacity: int = 4096,
        tier: str = "exact",
        block_rows: int = 1024,
        fused_bin_width: Optional[int] = None,
        store_dtype: str = "float32",
        ivf_clusters: Optional[int] = None,
        ivf_nprobe: int = 8,
        ivf_iters: int = 10,
        ivf_fine_dtype: str = "auto",
        ivf_tail_frac: float = 0.25,
        ivf_rebuild_min: int = 32768,
        ivf_refine_extra: Optional[int] = None,
        ivf_balance: float = 0.0,
        device=None,
        group=None,
    ) -> None:
        from modular_rag_system_tpu_torch.ops.ivf2 import check_fine_dtype

        if tier not in _TIERS:
            raise ValueError(f"ShardedIndex does not support tier {tier!r} "
                             f"(choose {'/'.join(_TIERS)})")
        if store_dtype not in _TORCH_DTYPES:
            raise ValueError(f"store_dtype must be float32|bfloat16, got {store_dtype}")
        if tier in ("ivf", "auto"):
            check_fine_dtype(ivf_fine_dtype)
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        if mesh is None:
            mesh = make_index_mesh(device=device or "cuda")
        self.hierarchical = isinstance(mesh[0], (list, tuple))
        self.mesh = ([[resolve_device(d) for d in m] for m in mesh] if self.hierarchical
                     else [resolve_device(d) for d in mesh])
        self.devices = ([d for m in self.mesh for d in m] if self.hierarchical
                        else self.mesh)
        self.device = resolve_device(device) if device is not None else self.devices[0]
        self.group = group
        if group is not None and self.hierarchical:
            raise ValueError("across processes the slices are the ranks: pass this "
                             "rank's shards as a flat list")
        # this process's first global shard, and the global shard count
        n_proc = 1 if group is None else group_size(group)
        self._s0 = 0 if group is None else torch.distributed.get_rank(group) * len(self.devices)
        self.S = n_proc * len(self.devices)
        self.dim = dim
        self.tier = tier
        self.store_dtype = store_dtype
        self._dtype = _TORCH_DTYPES[store_dtype]
        # rounded down to a power of two: cap_s is one, and a block_rows
        # that does not divide it would be a knob that changes results
        self.block_rows = 1 << (block_rows.bit_length() - 1)
        self.fused_bin_width = fused_bin_width
        self.cap_s = max(_next_pow2((capacity + self.S - 1) // self.S), self.block_rows)
        self.count = 0
        self._lock = threading.RLock()
        # write gate, as in DeviceIndex: held by every writer and across
        # build_ann's k-means and fill, which read the masters without
        # _lock; readers keep serving the old structure and the exact
        # tail.  Lock order: _build_gate -> _lock.
        self._build_gate = threading.RLock()
        self.E: List[torch.Tensor] = [
            torch.zeros((self.cap_s, dim), dtype=self._dtype, device=d) for d in self.devices]
        # derived copies, one per shard: when not None they are in sync
        # with E (writes update them, O(batch)); growth drops them
        self._E_q: Optional[List[torch.Tensor]] = None  # (cap_s, d) int8
        self._scales: Optional[List[torch.Tensor]] = None  # (cap_s, 1) f32
        self._E_bf16: Optional[List[torch.Tensor]] = None  # (cap_s, d) bf16
        self.ivf_clusters = ivf_clusters
        self.ivf_nprobe = ivf_nprobe
        self.ivf_iters = ivf_iters
        self.ivf_fine_dtype = ivf_fine_dtype
        self.ivf_tail_frac = ivf_tail_frac
        self.ivf_rebuild_min = ivf_rebuild_min
        self.ivf_refine_extra = ivf_refine_extra
        self.ivf_balance = ivf_balance
        # pending (centroids, global labels) warm start, consumed by the
        # next build
        self.ivf_warmstart = None
        self.ivf_rebuilds = 0
        # wall seconds of the last build (k-means + splits + fill)
        self.ivf_last_build_s = 0.0
        self._ivf2: Optional[_ShardedIVF2] = None

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.S * self.cap_s

    # ------------------------------------------------------------------
    # write path
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
                self._ensure_capacity(self.count + n)
                src = torch.as_tensor(mat)
                for c in range(0, n, _ADD_CHUNK_ROWS):
                    x = src[c:c + _ADD_CHUNK_ROWS].to(self.device, torch.float32)
                    self._append(x.to(self._dtype), first + c)
                self.count += n
            # threshold rebuild outside _lock (gate still held): queries
            # keep serving the old structure + exact tail during the build
            self._maybe_build_ivf2()
        return first, n

    def _append(self, x: torch.Tensor, start: int) -> None:
        """Write store-dtype rows of global ids [start, start + len(x)):
        shard s takes every S-th row from its first one, at a run of
        local rows."""
        S = self.S
        for c, dev in enumerate(self.devices):
            s = self._s0 + c
            sub = x[(s - start) % S::S]
            if sub.shape[0]:
                self._write_shard(c, slice(_count_s(start, s, S), None), sub.to(dev))

    def _write_shard(self, s: int, rows, m: torch.Tensor) -> None:
        """Write store-dtype rows ``m`` of local shard s at local ``rows`` (a
        slice from its start, or an index tensor) into the master and the
        derived copies."""
        if isinstance(rows, slice):
            rows = slice(rows.start, rows.start + m.shape[0])
        self.E[s][rows] = m
        if self._E_q is not None:
            qv, sc = quantize_rows(m)
            self._E_q[s][rows] = qv
            self._scales[s][rows] = sc
        if self._E_bf16 is not None:
            self._E_bf16[s][rows] = m.to(torch.bfloat16)

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap_s = _next_pow2((needed + self.S - 1) // self.S)
        grown = []
        for E_s in self.E:
            g = torch.zeros((new_cap_s, self.dim), dtype=self._dtype, device=E_s.device)
            g[: self.cap_s] = E_s
            grown.append(g)
        self.E = grown
        self.cap_s = new_cap_s
        # the ivf structure survives growth: the strided global <-> local
        # map does not depend on cap_s, and inv_perm covers the built rows
        self._E_q = self._scales = self._E_bf16 = None

    def _rows_by_shard(self, rows: np.ndarray):
        """(local shard, positions in ``rows``, local rows) of the rows
        given by id that this process's shards own."""
        rows = np.asarray(rows, dtype=np.int64)
        s_idx, j_idx = rows % self.S, rows // self.S
        for c in range(len(self.devices)):
            pos = np.nonzero(s_idx == self._s0 + c)[0]
            if pos.size:
                yield c, pos, j_idx[pos]

    def _set(self, rows: np.ndarray, mat: Optional[torch.Tensor]) -> None:
        """Overwrite rows (``mat`` f32 on the lead device) or zero them
        (``mat`` None), in E, the derived copies and the fine copy (whose
        built rows take the f32 values, as in ``DeviceIndex``)."""
        for s, pos, j in self._rows_by_shard(rows):
            dev = self.devices[s]
            m = (torch.zeros((len(pos), self.dim), dtype=torch.float32, device=dev)
                 if mat is None else mat[torch.from_numpy(pos).to(mat.device)].to(dev))
            self._write_shard(s, torch.from_numpy(j).to(dev), m.to(self._dtype))
            if self._ivf2 is not None:
                # a shard's local row is built exactly when its global row is
                self._ivf2.shards[s].update_rows(j, m)

    def delete_rows(self, rows: np.ndarray) -> None:
        """Zero deleted rows in E, the derived copies and the fine copy."""
        if len(rows) == 0:
            return
        with self._build_gate:
            with self._lock:
                self._set(rows, None)
            # rewrites count as drift: without this an update-only
            # workload would never rebuild
            self._maybe_build_ivf2()

    def set_rows(self, rows: np.ndarray, mat) -> None:
        """Overwrite existing rows (e.g. re-ingest of a deleted doc)."""
        if len(rows) == 0:
            return
        with self._build_gate:
            with self._lock:
                self._set(rows, torch.as_tensor(mat).to(self.device, torch.float32))
            self._maybe_build_ivf2()

    # ------------------------------------------------------------------
    # search (search_device, search, search_deep: _SearchFront)
    def effective_tier(self) -> str:
        """``tier="auto"``: int8 below ``DeviceIndex._AUTO_IVF_ROWS`` global
        rows, ivf at or above."""
        if self.tier != "auto":
            return self.tier
        return "ivf" if self.count >= DeviceIndex._AUTO_IVF_ROWS else "int8"

    def _effective_tier(self, k: int) -> str:
        """The route that serves k: ``deep`` past cap_s (no per-shard
        selection can return more than cap_s candidates); the ivf tier
        before its first build or at k > 64 serves the exact top-k per
        shard."""
        if k > self.cap_s:
            return "deep"
        tier = self.effective_tier()
        if tier == "ivf" and (self._ivf2 is None or k > _IVF_MAX_K):
            return "exact"
        return tier

    def _operands(self, tier: str) -> List[Tuple]:
        """Per local shard, (rows, scales, master) of a streaming tier
        (hold _lock), as ``DeviceIndex._operands``."""
        if tier == "int8":
            if self._E_q is None:
                q = [quantize_rows(E_s) for E_s in self.E]
                self._E_q = [x for x, _ in q]
                self._scales = [sc for _, sc in q]
            return list(zip(self._E_q, self._scales, self.E))
        if tier == "bf16" and self.store_dtype != "bfloat16":
            if self._E_bf16 is None:
                self._E_bf16 = [E_s.to(torch.bfloat16) for E_s in self.E]
            return [(E_s, None, None) for E_s in self._E_bf16]
        return [(E_s, None, None) for E_s in self.E]

    def _ivf_tail_s(self) -> int:
        tail = self.count - self._ivf2.built
        return 0 if tail <= 0 else min(
            max(8192, _next_pow2((tail + self.S - 1) // self.S)), self.cap_s)

    def _shard_search(self, tier: str, k: int):
        """fn(c, n, q) -> local shard c's (vals, local rows) over its n
        live rows (hold _lock)."""
        if tier in ("exact", "deep"):
            return lambda c, n, q: exact_ops.exact_topk_raw(self.E[c], n, q, k)
        if tier != "ivf":
            ops = self._operands(tier)
            bin_width, block_rows = self.fused_bin_width, min(self.block_rows, self.cap_s)
            return lambda c, n, q: stream_search_core(*ops[c], n, q, k, bin_width, block_rows)
        from modular_rag_system_tpu_torch.ops import ivf2 as ivf2_ops

        iv = self._ivf2
        nprobe = min(self.ivf_nprobe, iv.n_clusters)
        # the largest per-shard slot budget, rounded as the single-device
        # route rounds it (it sets the dump decision and the tie order)
        L = max(p.slots_for_nprobe(nprobe) for p in iv.shards)
        U = ivf2_ops.auto_u(L)
        L = ((L + U - 1) // U) * U
        tail_s = self._ivf_tail_s()

        def search(c, n, q):
            p = iv.shards[c]
            return ivf2_ops.ivf2_search_core(
                self.E[c], p.E_c3, p.scales3, p.perm, p.centroids, p.blk_start, p.nblk,
                p.counts, _count_s(iv.built, self._s0 + c, self.S), n, q, k=k,
                nprobe=nprobe, L=L, tail_max=tail_s, refine_extra=self.ivf_refine_extra)

        return search

    def _search_device(self, q: torch.Tensor, k: int, deep: bool):
        """Each shard's top-k, then the merge: within this rank's slice
        (or each slice of a hierarchical layout) first, then across."""
        with self._lock:
            k_eff = min(k, self.count)
            if k_eff == 0:
                return _pad_absent(*_no_rows(q), k)
            tier = "deep" if deep else self._effective_tier(k_eff)
            k_s = min(k_eff, self.cap_s)
            shard = self._shard_search(tier, k_s)
            S, vals, gids = self.S, [], []
            for c, dev in enumerate(self.devices):
                s = self._s0 + c
                with _on(dev):
                    v, loc = shard(c, _count_s(self.count, s, S), q.to(dev))
                gids.append(torch.where(torch.isfinite(v) & (loc >= 0), loc * S + s,
                                        _BIG_I32).to(torch.int32))
                vals.append(torch.where(gids[-1] < _BIG_I32, v, _NEG_INF))
            if self.group is not None:
                # within this rank's slice, then k candidates a rank
                # across the ranks, merged in rank order on every rank
                v, g = _merge(vals, gids, min(k_eff, len(self.devices) * k_s), q.device)
                part = all_gather_candidates(v, g, self.group)
                v, g = _merge([p[0] for p in part], [p[1] for p in part], k_eff, q.device)
            elif self.hierarchical:
                # within each slice first (on the slice's first device),
                # then k candidates per slice across slices
                n = len(self.mesh[0])
                part = [_merge(vals[i * n:(i + 1) * n], gids[i * n:(i + 1) * n],
                               min(k_eff, n * k_s), m[0]) for i, m in enumerate(self.mesh)]
                v, g = _merge([p[0] for p in part], [p[1] for p in part], k_eff, q.device)
            else:
                v, g = _merge(vals, gids, k_eff, q.device)
        return _pad_absent(v, torch.where(torch.isfinite(v), g, -1), k)

    def empty_like(self, capacity: int) -> "ShardedIndex":
        """A fresh, empty index of this one's layout, group, lead device
        and knobs, with room for ``capacity`` rows (at least 4096)."""
        return ShardedIndex(dim=self.dim, mesh=self.mesh, capacity=max(capacity, 4096),
                            device=self.device, group=self.group,
                            **_index_tier_kwargs(self))

    # ------------------------------------------------------------------
    # ivf tier: global k-means, per-shard cluster-contiguous slabs
    def build_ann(self) -> None:
        """(Re)build the sharded cluster-contiguous structure.  The
        k-means is global (``kmeans_fit_sharded``); each shard lays its own
        rows out over the shared clusters.  A pending ``ivf_warmstart``
        (a snapshot's centroids and global labels) is consumed once: the
        build skips k-means and the splits."""
        from modular_rag_system_tpu_torch.ops import ivf2 as V
        from modular_rag_system_tpu_torch.ops import kmeans as km

        if self.group is not None:
            _refuse_across_processes("build the ivf structure")
        with self._build_gate:
            # a consistent view under the state lock, then the heavy
            # k-means + fill without it (writers are excluded by the gate)
            with self._lock:
                count, E = self.count, list(self.E)
                warm = self.ivf_warmstart
                self.ivf_warmstart = None  # single use
                fdt = self.ivf_fine_dtype
                if fdt == "auto":
                    fdt = "int8" if count > DeviceIndex._IVF_AUTO_INT8_ROWS else "bf16"
            if count == 0:
                return
            t0 = time.perf_counter()
            S, lead = self.S, self.device
            C = self.ivf_clusters
            if C is None:
                C = int(max(8, min(count, round(count ** 0.5))))
            C = min(max(C, 1), count)
            if warm is not None:
                cents_h, labels_g = warm
                if not (0 < len(labels_g) <= count and cents_h.shape[1] == self.dim):
                    warm = None
                else:
                    lg = np.asarray(labels_g, np.int32)
                    if lg.min() < 0 or lg.max() >= cents_h.shape[0]:
                        logger.warning("warm_start labels out of range [0, %d); "
                                       "re-running k-means", cents_h.shape[0])
                        warm = None
            if warm is not None:
                built = len(lg)
                centroids = torch.tensor(np.asarray(cents_h, np.float32), device=lead)
                labels = []
                for s, E_s in enumerate(E):
                    lab = torch.full((E_s.shape[0],), -1, dtype=torch.int32, device=E_s.device)
                    lab[:_count_s(built, s, S)] = torch.from_numpy(lg[s::S].copy()).to(E_s.device)
                    labels.append(lab)
                return self._finish_ann_build(centroids, labels, built, fdt, t0, True)
            # seeds: evenly spaced global rows, jittered (IVF2.build's
            # init), from one generator that the splits go on with
            seed_g = np.linspace(0, count - 1, C).astype(np.int64)
            seeds = np.empty((C, self.dim), np.float32)
            for s, pos, j in self._rows_by_shard(seed_g):
                seeds[pos] = E[s][torch.from_numpy(j).to(E[s].device)].float().cpu().numpy()
            rng = np.random.default_rng(0)
            init = seeds + rng.standard_normal(seeds.shape).astype(np.float32) * 1e-4
            init /= np.maximum(np.linalg.norm(init, axis=1, keepdims=True), 1e-12)
            centroids, labels = km.kmeans_fit_sharded(E, count, init, iters=self.ivf_iters,
                                                      device=lead)
            if self.ivf_balance:
                # LBG splits of clusters past ivf_balance x the average,
                # from global counts, then a short Lloyd re-run
                cap_rows = max(int(np.ceil(self.ivf_balance * count / C)), V.SLAB)
                for _ in range(2):
                    Ccur = int(centroids.shape[0])
                    cnts = sum(torch.bincount(torch.where(lab >= 0, lab.long(), Ccur),
                                              minlength=Ccur + 1)[:Ccur].cpu()
                               for lab in labels).numpy()
                    seeds2 = V.lbg_split_seeds(centroids.cpu().numpy(), cnts, cap_rows, rng)
                    if seeds2 is None:
                        break
                    grown = np.concatenate([centroids.cpu().numpy(), seeds2], axis=0)
                    centroids, labels = km.kmeans_fit_sharded(E, count, grown, iters=3,
                                                              device=lead)
            return self._finish_ann_build(centroids, labels, count, fdt, t0, False)

    def _finish_ann_build(self, centroids, labels, built: int, fdt: str, t0: float,
                          warm_started: bool) -> None:
        """Per shard, the cluster-sorted order of its built rows and the
        chunked fill of its slabs, all shards padded to one block count
        (as the JAX package's stacked arrays are); then the swap under the
        state lock.  Global rows [built, count) stay in the exact tail."""
        from modular_rag_system_tpu_torch.ops import ivf2 as V

        S, C, d = self.S, int(centroids.shape[0]), self.dim
        oc = [V.order_counts_core(lab, _count_s(built, s, S), C)
              for s, lab in enumerate(labels)]
        counts_h = np.stack([c.cpu().numpy() for _, c in oc]).astype(np.int64)  # (S, C)
        nblk_h = (counts_h + V.SLAB - 1) // V.SLAB
        nbp = max(int(nblk_h.sum(axis=1).max()), 1)
        # clamped as a single-device build: a small build must not
        # allocate a 1024-block fine copy
        CHUNK = min(1024, 1 << max(nbp - 1, 1).bit_length())
        nbp = ((nbp + CHUNK - 1) // CHUNK) * CHUNK
        blk_start_h = np.cumsum(nblk_h, axis=1) - nblk_h
        row_start_h = np.cumsum(counts_h, axis=1) - counts_h
        scaled = fdt in ("int8", "int4")
        slab_p = V.SLAB // 2 if fdt == "int4" else V.SLAB
        shards = []
        for s, (E_s, (order, counts)) in enumerate(zip(self.E, oc)):
            dev = E_s.device

            def i32(a):
                return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

            bc = np.full(nbp, C - 1, np.int32)
            bc[:nblk_h[s].sum()] = np.repeat(np.arange(C, dtype=np.int32), nblk_h[s])
            # every shard owns its tensors, the centroids too
            bs, rs, bclus, cents = i32(blk_start_h[s]), i32(row_start_h[s]), i32(bc), \
                centroids.to(dev, copy=True)
            E_c3 = torch.zeros((nbp, slab_p, d),
                               dtype=torch.int8 if scaled else torch.bfloat16, device=dev)
            scales3 = (torch.zeros((nbp, V.SLAB), dtype=torch.float32, device=dev)
                       if scaled else None)
            perm = torch.full((nbp * V.SLAB,), -1, dtype=torch.int32, device=dev)
            inv = torch.full((E_s.shape[0] + 1,), -1, dtype=torch.int32, device=dev)
            for lo in range(0, nbp, CHUNK):
                V._fill_chunk_core(E_c3, scales3, perm, inv, E_s, order, counts, bs, rs,
                                   bclus, cents, lo, CHUNK, fdt)
            iv = V.IVF2(cents, E_c3, scales3, perm, inv, bs, i32(nblk_h[s]), counts,
                        _count_s(built, s, S), fdt, block_cluster=bclus)
            iv.warm_started = warm_started
            shards.append(iv)
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with self._lock:
            self.ivf_last_build_s = time.perf_counter() - t0
            self._ivf2 = _ShardedIVF2(shards, built, fdt, self.ivf_rebuilds)
            self.ivf_rebuilds += 1

    # ------------------------------------------------------------------
    def snapshot(self, path: str) -> None:
        """Persist live rows in GLOBAL row order, in the stored dtype (the
        format of ``DeviceIndex.snapshot`` and of both JAX indexes, so a
        file loads into any of them); a built ivf structure adds its
        centroids and global per-row labels for a warm start."""
        if self.group is not None:
            _refuse_across_processes("write a snapshot")
        with self._lock:
            count, S = self.count, self.S
            live = torch.empty((count, self.dim), dtype=self._dtype)
            for s, E_s in enumerate(self.E):
                live[s::S] = E_s[:_count_s(count, s, S)].cpu()
            extra = {}
            iv = self._ivf2
            if iv is not None and iv.built > 0:
                extra = {"ivf_centroids": iv.shards[0].centroids.float().cpu().numpy(),
                         "ivf_labels": iv.labels_host_global(S)}
        if self.store_dtype == "bfloat16":
            np.savez(path, embeddings_bf16=live.view(torch.int16).numpy().view(np.uint16),
                     count=count, dim=self.dim, **extra)
        else:
            np.savez(path, embeddings=live.numpy(), count=count, dim=self.dim, **extra)

    @classmethod
    def load(cls, path: str, mesh=None, tier: str = "exact", device=None,
             **tier_kwargs) -> "ShardedIndex":
        """Rebuild a sharded index from a snapshot file (written by either
        index kind of either package); ``tier_kwargs`` passes every
        constructor knob through, ``store_dtype`` is inferred from the
        file, and saved ivf centroids + labels warm-start the rebuild that
        the append triggers."""
        if tier_kwargs.get("group") is not None:
            _refuse_across_processes("load a snapshot")
        data = np.load(path)
        count = int(data["count"])
        store_dtype = "bfloat16" if "embeddings_bf16" in data else "float32"
        idx = cls(dim=int(data["dim"]), mesh=mesh, capacity=max(count, 4096), tier=tier,
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
        """Device bytes of the masters, the derived copies and the ivf
        structure, over this process's shards."""
        rows = len(self.devices) * self.cap_s
        b = rows * self.dim * self.E[0].element_size()
        if self._E_q is not None:
            b += rows * self.dim + rows * 4
        if self._E_bf16 is not None:
            b += rows * self.dim * 2
        if self._ivf2 is not None:
            b += self._ivf2.memory_bytes()
        return b


class _ShardedIVF2:
    """The sharded ivf structure: one ``ops.ivf2.IVF2`` per shard over the
    SAME clusters (each with its own copy of the centroids on its
    device), laid out over the shard's local rows.  ``built`` counts
    GLOBAL rows; shard s's built prefix is its first
    ``ceil((built - s) / S)`` local rows."""

    def __init__(self, shards, built: int, fine_dtype: str, version: int) -> None:
        self.shards = shards
        self.built = int(built)
        self.fine_dtype = fine_dtype
        self.version = int(version)
        self.warm_started = shards[0].warm_started
        self.nblk_h = np.stack([p.nblk_h for p in shards])  # (S, C)

    @property
    def n_clusters(self) -> int:
        return int(self.nblk_h.shape[1])

    @property
    def stale_rows(self) -> int:
        return sum(p.stale_rows for p in self.shards)

    def fine_bytes(self) -> int:
        return sum(p.fine_bytes() for p in self.shards)

    def memory_bytes(self) -> int:
        return sum(p.memory_bytes() for p in self.shards)

    def labels_host_global(self, S: int) -> np.ndarray:
        """Global per-row cluster labels of rows [0, built): global row g
        is local row g // S of shard g % S."""
        labels = np.full(self.built, -1, np.int32)
        for s, p in enumerate(self.shards):
            labels[s::S] = p.labels_host()
        return labels
