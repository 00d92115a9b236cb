"""RAGEngine — the core retrieval engine on a PyTorch device.

Ingest: chunk -> encode on the device (the bulk path keeps embeddings on
the device) -> document store upsert + index append.  Query: the
encoder's ``encode_device`` embeds the batch on the device, the index's
``search_device`` searches it there, and the document store resolves
the rows.  Behaviour follows the JAX package's
``RAGEngine``: recent-context deque, rolling retrieval-time stats,
overfetch-and-refill under filters, positional restore with tombstones,
the enhanced-context builder and the lifecycle methods (retention
cleanup, compaction, re-embedding, gzip JSON export).  With
``mesh.index_shards > 1`` the index is a ``ShardedIndex``
(``parallel/sharded.py``) over the devices ``index_devices`` lists (by
default one card a shard), and the engine's device runs the encoder and
the merge.  With ``mesh.multihost`` every process of a
``torch.distributed`` group runs the same engine (``parallel/
multihost.py``): the index's slices are the processes, each holding its
own shards, every process issues the same writes (the SPMD ingest
contract) and keeps its own store, and a search merges the ranks'
candidates.

Threads: queries run from several threads at once (the HTTP server's
query batcher flushes concurrently).  Each query searches one index
object and resolves its rows against one store numbering: ``compact``
renumbers the store and swaps the index under ``_write_lock`` and marks
the swap, and a query whose search and fetch straddle it runs again.
Lock order: ``_write_lock``, then the index's locks.
"""

from __future__ import annotations

import re
import threading
import time
from collections import Counter, deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from modular_rag_system_tpu_torch.chunker import TextChunker
from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.index import (
    DeviceIndex,
    _index_tier_kwargs,
    snapshot_embeddings,
)
from modular_rag_system_tpu_torch.models import build_encoder
from modular_rag_system_tpu_torch.parallel.mesh import (
    make_hierarchical_index_mesh,
    make_index_mesh,
)
from modular_rag_system_tpu_torch.parallel.sharded import ShardedIndex
from modular_rag_system_tpu_torch.store import DocumentStore
from modular_rag_system_tpu_torch.types import Document, Query, RetrievalResult, as_matrix
from modular_rag_system_tpu_torch.utils.device import resolve_device
from modular_rag_system_tpu_torch.utils.profiling import TRACER
from modular_rag_system_tpu_torch.utils.resilience import retry_transient

_STOPWORDS = frozenset(
    """a an and are as at be by for from has he in is it its of on that the to was
    were will with this these those i you your we our they them what which who how
    when where why not no yes do does did done can could should would may might
    must shall about into over under again further then once here there all any
    both each few more most other some such only own same so than too very s t
    just don now""".split()
)


class RAGEngine:
    def __init__(self, config: Optional[RAGConfig] = None, device="cuda",
                 index_devices: Optional[Sequence] = None) -> None:
        """``index_devices``: the shards' devices when ``mesh.index_shards
        > 1`` (may repeat a device; default ``cuda:0`` .. ``cuda:S-1``, or
        S copies of ``cpu`` on the CPU)."""
        self.config = config or RAGConfig()
        mc = self.config.mesh
        self.device = resolve_device(device)
        group = None
        if mc.multihost:
            # join the group and derive the mesh defaults before the
            # layout is built: a process's local shards are
            # index_devices, else the engine's one device
            from modular_rag_system_tpu_torch.parallel import multihost

            multihost.ensure_multihost(self.config, index_devices or [self.device])
            if multihost.world_size() > 1:
                group = torch.distributed.group.WORLD
        # the shards' layout first: too few cards raises before any build
        shard_mesh = None
        if group is not None:
            W = multihost.world_size()
            if mc.dcn_slices != W or mc.index_shards % W:
                raise ValueError(
                    f"across {W} processes the index's slices are the processes: "
                    f"dcn_slices must be {W} (got {mc.dcn_slices}) and index_shards "
                    f"a multiple of it (got {mc.index_shards})")
            per = mc.index_shards // W
            shard_mesh = ([self.device] if per == 1 and index_devices is None
                          else make_index_mesh(per, index_devices, self.device))
        elif mc.index_shards > 1:
            if mc.dcn_slices > 1:
                if mc.index_shards % mc.dcn_slices:
                    raise ValueError(f"index_shards ({mc.index_shards}) must divide by "
                                     f"dcn_slices ({mc.dcn_slices})")
                shard_mesh = make_hierarchical_index_mesh(
                    mc.dcn_slices, mc.index_shards // mc.dcn_slices, index_devices, self.device)
            else:
                shard_mesh = make_index_mesh(mc.index_shards, index_devices, self.device)
        self.encoder = build_encoder(self.config, device=self.device)
        # the index is sized from the ENCODER's dim (a hybrid encoder is
        # wider than embedding.dim); the config is not written back
        self.embed_dim = int(getattr(self.encoder, "dim", 0) or self.config.embedding.dim)
        self.chunker = TextChunker(
            chunk_size_tokens=self.config.embedding.chunk_size_tokens,
            overlap_tokens=self.config.embedding.chunk_overlap_tokens,
            token_counter=getattr(self.encoder, "token_count", None),
        )
        self.store = DocumentStore(self.config.store.storage_path)
        ic = self.config.index
        if shard_mesh is not None:
            self.index = ShardedIndex(dim=self.embed_dim, mesh=shard_mesh,
                                      capacity=ic.initial_capacity, device=self.device,
                                      group=group, **_index_tier_kwargs(ic))
        else:
            self.index = DeviceIndex(dim=self.embed_dim, capacity=ic.initial_capacity,
                                     device=self.device, **_index_tier_kwargs(ic))
        self.recent_context: deque = deque(
            maxlen=self.config.retrieval.recent_context_size)
        self.query_stats: Dict[str, float] = {
            "total_queries": 0,
            "avg_retrieval_time": 0.0,
            "total_documents_added": 0,
        }
        self._snapshot_path = Path(self.config.store.storage_path) / "index.npz"
        # store.upsert + index.add must be atomic together: interleaved
        # writers would desynchronize store rows from index rows
        self._write_lock = threading.RLock()
        # compact() renumbers the store's rows: _swap_gen is odd while it
        # runs and _stable is clear, so a query can tell that its search
        # and its store fetch saw different numberings (_search_fetch)
        self._swap_gen = 0
        self._stable = threading.Event()
        self._stable.set()
        self._stats_lock = threading.Lock()
        self._restore()

    # ------------------------------------------------------------------
    # persistence
    def _restore(self) -> None:
        """Reload the index from its snapshot (saved ivf centroids + labels
        warm-start the rebuild the append triggers); re-embed any store
        rows the snapshot is missing, positionally (tombstones become
        zero rows)."""
        n_store = self.store.max_row() + 1
        if self._snapshot_path.exists():
            data = np.load(self._snapshot_path)
            if int(data["dim"]) == self.index.dim and int(data["count"]) <= max(n_store, 0):
                emb = snapshot_embeddings(data)[: int(data["count"])]
                if "ivf_centroids" in data:
                    self.index.ivf_warmstart = (data["ivf_centroids"],
                                                data["ivf_labels"])
                try:
                    if emb.shape[0]:
                        self.index.add(np.asarray(emb, dtype=np.float32))
                finally:
                    # a warm start left over from a failed add could be
                    # consumed by a later rebuild over another corpus
                    self.index.ivf_warmstart = None
        if self.index.count < n_store:
            missing: List[Optional[Document]] = [
                doc for row, doc in self.store.iter_all(include_deleted=True)
                if row >= self.index.count]
            if missing:
                live_mat = self._encode([d.content for d in missing if d is not None])
                mat = np.zeros((len(missing), self.index.dim), np.float32)
                li = 0
                for i, d in enumerate(missing):
                    if d is not None:
                        mat[i] = live_mat[li]
                        li += 1
                self.index.add(mat)
        deleted = self.store.deleted_rows()
        if deleted.size:
            self.index.delete_rows(deleted[deleted < self.index.count])

    def save(self) -> None:
        self.index.snapshot(str(self._snapshot_path))

    # ------------------------------------------------------------------
    # ingest
    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.index.dim), np.float32)
        return retry_transient(
            lambda: np.asarray(self.encoder.encode(list(texts))),
            what="encoder forward")

    def add_documents(self, docs: Sequence[Document]) -> List[str]:
        """Batch add (pre-embedded or not). Returns ids. Idempotent."""
        docs = list(docs)
        if not docs:
            return []
        with TRACER.root("engine.add_documents"):
            emb_dev = None
            if all(d.embedding is None for d in docs) and hasattr(self.encoder, "encode_device"):
                # device-resident bulk path: embeddings never touch the host
                emb_dev = retry_transient(
                    lambda: self.encoder.encode_device([d.content for d in docs]),
                    what="encoder forward")
            else:
                need = [d for d in docs if d.embedding is None]
                if need:
                    mat = self._encode([d.content for d in need])
                    for d, e in zip(need, mat):
                        d.embedding = e
            with self._write_lock:
                return self._place_documents(docs, emb_dev)

    def _place_documents(self, docs: Sequence[Document], emb_dev=None) -> List[str]:
        placements = self.store.upsert_batch(docs)
        new_pos = [i for i, (_r, status) in enumerate(placements) if status == "new"]
        if new_pos:
            first_new = min(placements[i][0] for i in new_pos)
            if first_new != self.index.count:
                raise RuntimeError(
                    f"store/index row drift: store row {first_new}, "
                    f"index count {self.index.count}")
            if emb_dev is not None:
                new_mat = emb_dev if len(new_pos) == len(docs) else emb_dev[new_pos]
            else:
                new_mat = as_matrix(
                    [np.asarray(docs[i].embedding, dtype=np.float32) for i in new_pos],
                    self.index.dim)
            with TRACER.span("index.add"):
                self.index.add(new_mat)
        # re-ingest of previously deleted docs: their index rows were
        # zeroed by delete_rows, so write the fresh embeddings back
        res_pos = [i for i, (_r, status) in enumerate(placements) if status == "resurrected"]
        if res_pos:
            res_rows = np.asarray([placements[i][0] for i in res_pos], dtype=np.int64)
            if emb_dev is not None:
                res_mat = emb_dev[res_pos]
            else:
                res_mat = as_matrix(
                    [np.asarray(docs[i].embedding, dtype=np.float32) for i in res_pos],
                    self.index.dim)
            self.index.set_rows(res_rows, res_mat)
        self.query_stats["total_documents_added"] += len(new_pos)
        return [d.id for d in docs]

    def add_document(
        self,
        content: str,
        metadata: Optional[Dict[str, Any]] = None,
        source: str = "unknown",
        content_type: str = "document",
        importance: float = 1.0,
    ) -> str:
        doc = Document(content=content, metadata=metadata or {}, source=source,
                       content_type=content_type, importance=importance)
        return self.add_documents([doc])[0]

    def add_text(
        self,
        text: str,
        content_type: str = "document",
        source: str = "unknown",
        metadata: Optional[Dict[str, Any]] = None,
    ) -> List[str]:
        """Chunk + embed + add: the convenience ingest path."""
        docs = [
            Document(
                content=c.text,
                content_type=content_type,
                source=source,
                metadata={**(metadata or {}), "chunk_index": c.index,
                          "chunk_total": c.total},
            )
            for c in self.chunker.chunk_text(text, content_type)
        ]
        return self.add_documents(docs)

    # ------------------------------------------------------------------
    # query
    def query(
        self,
        query_text: str,
        context: Optional[Dict[str, Any]] = None,
        max_results: Optional[int] = None,
        source_filters: Optional[List[str]] = None,
        similarity_threshold: Optional[float] = None,
        time_weight: Optional[float] = None,
    ) -> RetrievalResult:
        r = self.config.retrieval
        q = Query(
            text=query_text,
            context=dict(context or {}),
            max_results=max_results if max_results is not None else r.max_results,
            similarity_threshold=(similarity_threshold if similarity_threshold is not None
                                  else r.similarity_threshold),
            time_weight=time_weight if time_weight is not None else r.time_weight,
            source_filters=source_filters,
        )
        q.context["recent_context"] = list(self.recent_context)[-10:]
        t0 = time.perf_counter()
        result = self._retrieve(q)
        result.retrieval_time = time.perf_counter() - t0
        self._update_query_stats(result.retrieval_time)
        self.recent_context.append(
            {"query": query_text, "timestamp": time.time(), "n_results": len(result.documents)})
        return result

    # kernel-path refills stop at _REFILL_KERNEL_MAX; one final deep pass
    # runs through the exact path (any k) up to _REFILL_EXACT_MAX
    _REFILL_KERNEL_MAX = 1024
    _REFILL_EXACT_MAX = 16384

    def _next_refill_k(self, k: int) -> Optional[int]:
        if k < min(self._REFILL_KERNEL_MAX, self.index.count):
            return min(k * 4, self._REFILL_KERNEL_MAX, self.index.count)
        if k < min(self._REFILL_EXACT_MAX, self.index.count):
            return min(self._REFILL_EXACT_MAX, self.index.count)
        return None

    def _search_batch(self, index, texts: List[str], k: int):
        """(scores (Q,k), rows (Q,k), q_emb (Q,d) or None) from ``index``."""
        if k > self._REFILL_KERNEL_MAX:
            # deep filtered refill: exact path, any k
            q_emb = np.asarray(self.encoder.encode_queries(texts))
            scores, rows = index.search_deep(q_emb, k)
            return scores, rows, q_emb
        if hasattr(self.encoder, "encode_device"):
            def device_query():
                vals, rows = index.search_device(self.encoder.encode_device(texts), k)
                return vals.cpu().numpy(), rows.cpu().numpy()

            scores, rows = retry_transient(device_query, what="device query")
            return scores, rows, None
        q_emb = np.asarray(self.encoder.encode_queries(texts))
        scores, rows = index.search(q_emb, k)
        return scores, rows, q_emb

    def _search_fetch(self, texts: List[str], k: int):
        """Search and store fetch over one index and one row numbering:
        (scores, rows, q_emb, rows -> documents, rows searched).  A
        ``compact`` that swaps them between the two makes the pair run
        again."""
        while True:
            self._stable.wait()
            gen = self._swap_gen
            if gen % 2:
                continue  # a compaction began after the wait
            index = self.index
            count = index.count
            if count == 0:  # everything was compacted away
                empty = np.zeros((len(texts), 0))
                return empty, empty.astype(np.int64), None, {}, 0
            scores, rows, q_emb = self._search_batch(index, texts, min(max(k, 1), count))
            by_row = self._fetch_by_row(rows)
            if self._swap_gen == gen:
                return scores, rows, q_emb, by_row, count

    def _postprocess_rows(self, q: Query, scores, rows, by_row, now: float):
        """Filter + rank one query's candidate rows."""
        docs: List[Document] = []
        sims: List[float] = []
        for score, r in zip(scores, rows):
            doc = by_row.get(int(r)) if r >= 0 else None
            if doc is None or not np.isfinite(score):
                continue  # deleted / padded slot
            sim = float(np.clip(score, 0.0, 1.0))
            if sim < q.similarity_threshold:
                continue
            if q.source_filters and doc.source not in q.source_filters:
                continue
            if q.metadata_filters and any(
                doc.metadata.get(mk) != mv for mk, mv in q.metadata_filters.items()
            ):
                continue
            docs.append(doc)
            age_days = max(now - doc.timestamp, 0.0) / 86400.0
            recency = float(np.exp(-age_days / 7.0))
            sims.append((1.0 - q.time_weight) * sim + q.time_weight * recency)
        order = np.argsort(sims)[::-1][: q.max_results]
        return [docs[i] for i in order], [sims[i] for i in order]

    def _fetch_by_row(self, rows) -> Dict[int, Document]:
        flat = sorted({int(r) for r in np.asarray(rows).ravel() if r >= 0})
        return {r: d for r, d in zip(flat, self.store.get_by_rows(flat))}

    def _initial_k(self, max_results: int, filters_active: bool) -> int:
        overfetch = self.config.index.overfetch if filters_active else 2
        return min(max(max_results * overfetch, max_results), self.index.count)

    def _retrieve(self, q: Query) -> RetrievalResult:
        if self.index.count == 0:
            return RetrievalResult([], [], None, 0.0, 0)
        filters_active = bool(q.source_filters or q.metadata_filters)
        k = self._initial_k(q.max_results, filters_active)
        while True:
            scores, rows, q_emb, by_row, count = self._search_fetch([q.text], k)
            docs, sims = self._postprocess_rows(q, scores[0], rows[0], by_row, time.time())
            # a selective filter can consume the whole candidate set:
            # rescan deeper; threshold misses never refill
            if len(docs) >= q.max_results or not filters_active:
                break
            nk = self._next_refill_k(k)
            if nk is None or nk <= k:
                break
            k = nk
        return RetrievalResult(
            documents=docs,
            similarities=sims,
            query_embedding=q_emb[0] if q_emb is not None else None,
            retrieval_time=0.0,
            total_documents_searched=count,
        )

    def _update_query_stats(self, dt: float) -> None:
        with self._stats_lock:  # queries update it from several threads
            s = self.query_stats
            n = s["total_queries"]
            s["avg_retrieval_time"] = (s["avg_retrieval_time"] * n + dt) / (n + 1)
            s["total_queries"] = n + 1

    def query_batch(
        self,
        texts: Sequence[str],
        max_results: int = 5,
        source_filters: Optional[List[str]] = None,
        similarity_threshold: Optional[float] = None,
        time_weight: Optional[float] = None,
        metadata_filters: Optional[Dict[str, Any]] = None,
    ) -> List[RetrievalResult]:
        """Many queries, one forward and one search; the semantics of
        ``query`` (threshold, filters, time_weight, refill)."""
        if self.index.count == 0 or not texts:
            return [RetrievalResult([], [], None, 0.0, 0) for _ in texts]
        r = self.config.retrieval
        queries = [
            Query(
                text=t,
                max_results=max_results,
                similarity_threshold=(similarity_threshold if similarity_threshold is not None
                                      else r.similarity_threshold),
                time_weight=time_weight if time_weight is not None else r.time_weight,
                source_filters=source_filters,
                metadata_filters=metadata_filters,
            )
            for t in texts
        ]
        filters_active = bool(source_filters or metadata_filters)
        k = self._initial_k(max_results, filters_active)
        t0 = time.perf_counter()
        while True:
            scores, rows, q_emb, by_row, count = self._search_fetch(list(texts), k)
            now = time.time()
            per_q = [self._postprocess_rows(q, scores[qi], rows[qi], by_row, now)
                     for qi, q in enumerate(queries)]
            if all(len(docs) >= max_results for docs, _ in per_q) or not filters_active:
                break
            nk = self._next_refill_k(k)
            if nk is None or nk <= k:
                break
            k = nk
        dt = time.perf_counter() - t0
        return [
            RetrievalResult(docs, sims, q_emb[qi] if q_emb is not None else None,
                            dt, count)
            for qi, (docs, sims) in enumerate(per_q)
        ]

    # ------------------------------------------------------------------
    # enhanced context (the reference's ``get_enhanced_context``)
    def get_enhanced_context(self, query_text: str, max_results: int = 10) -> Dict[str, Any]:
        res = self.query(query_text, max_results=max_results, similarity_threshold=0.0)
        docs = res.documents
        if not docs:
            return {"summary": "No relevant context found.", "documents": [],
                    "temporal_span_days": 0.0, "source_distribution": {},
                    "peak_hours": [], "themes": []}
        ts = [d.timestamp for d in docs]
        span_days = (max(ts) - min(ts)) / 86400.0
        source_dist = dict(Counter(d.source for d in docs))
        hours = Counter(time.localtime(t).tm_hour for t in ts)
        peak_hours = [h for h, _ in hours.most_common(3)]
        words = re.findall(r"[a-zA-Z]{3,}", " ".join(d.content for d in docs).lower())
        themes = [w for w, _ in Counter(w for w in words if w not in _STOPWORDS).most_common(10)]
        summary = (
            f"Found {len(docs)} relevant documents spanning "
            f"{span_days:.1f} days from sources {sorted(source_dist)}. "
            f"Key themes: {', '.join(themes[:5])}."
        )
        return {
            "summary": summary,
            "documents": [d.to_dict() for d in docs],
            "similarities": res.similarities,
            "retrieval_time": res.retrieval_time,
            "total_documents_searched": res.total_documents_searched,
            "temporal_span_days": span_days,
            "source_distribution": source_dist,
            "peak_hours": peak_hours,
            "themes": themes,
        }

    # ------------------------------------------------------------------
    # lifecycle
    def cleanup_old_documents(self, retention_days: Optional[float] = None) -> int:
        """Delete the documents older than ``retention_days`` (default
        ``store.retention_days``; None keeps everything); returns how many."""
        days = retention_days if retention_days is not None else self.config.store.retention_days
        if days is None:
            return 0
        with self._write_lock:
            n = self.store.delete_older_than(time.time() - days * 86400.0)
            deleted = self.store.deleted_rows()
            if deleted.size:
                self.index.delete_rows(deleted[deleted < self.index.count])
        return n

    def compact(self) -> int:
        """Physically drop deleted rows: renumber the store densely and
        rebuild the device index from the surviving embeddings.  Returns
        the number of rows reclaimed."""
        with self._write_lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        before = self.index.count
        # snapshot live embeddings in OLD row order
        self.index.snapshot(str(self._snapshot_path))
        emb = np.asarray(snapshot_embeddings(np.load(self._snapshot_path)), dtype=np.float32)
        self._stable.clear()
        self._swap_gen += 1  # odd: store rows and index rows may disagree
        try:
            live_old = self.store.compact()
            index = self.index.empty_like(len(live_old))
            if len(live_old):
                index.add(emb[np.asarray(live_old, dtype=np.int64)])
            self.index = index
        finally:
            self._swap_gen += 1
            self._stable.set()
        self.save()
        return before - self.index.count

    def reembed_all(self) -> int:
        """Re-encode every live document with the current encoder weights
        and rebuild the index (rows keep their numbers; tombstones stay
        zero rows).  Returns the number of rows re-embedded."""
        with self._write_lock:
            rows: List[int] = []
            texts: List[str] = []
            tombstones: List[int] = []
            for row, doc in self.store.iter_all(include_deleted=True):
                if doc is None:
                    tombstones.append(row)
                else:
                    rows.append(row)
                    texts.append(doc.content)
            n_total = (max(rows + tombstones) + 1) if (rows or tombstones) else 0
            if n_total == 0:
                return 0
            live_mat = self._encode(texts)
            mat = np.zeros((n_total, self.index.dim), np.float32)
            mat[np.asarray(rows, dtype=np.int64)] = live_mat
            index = self.index.empty_like(n_total)
            index.add(mat)
            if tombstones:
                index.delete_rows(np.asarray(tombstones, dtype=np.int64))
            self.index = index
            self.save()
            return len(rows)

    # ------------------------------------------------------------------
    def get_system_stats(self) -> Dict[str, Any]:
        index = self.index
        return {
            "query_stats": dict(self.query_stats),
            "store": self.store.stats(),
            "index": {
                "tier": index.tier,
                "effective_tier": index.effective_tier(),
                "count": index.count,
                "capacity": index.capacity,
                "dim": index.dim,
                "memory_bytes": index.memory_bytes(),
                "device": str(self.device),
                "ivf": index.ivf_stats(),
            },
            "encoder": getattr(self.encoder, "name", "unknown"),
            "recent_context_size": len(self.recent_context),
        }

    def export_data(self, path: str) -> str:
        return self.store.export_gzip_json(path)

    def shutdown(self) -> None:
        if self.config.store.snapshot_on_shutdown:
            self.save()
        self.store.close()
