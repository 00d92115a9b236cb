"""EmbeddingPipeline — chunk + batch-encode + cache + stats.

Parity target: the reference ``EmbeddingPipeline``
(``embedding_pipeline.py:509-742``) with its performance bugs designed
out:

* ALL cache-miss chunks of a request are encoded in ONE batched device
  forward (the reference did one HTTP round-trip or one un-batched CPU
  forward per chunk, ``embedding_pipeline.py:363-370,424``),
* ``batch_process`` has no artificial ``0.1 s`` inter-batch sleep
  (``embedding_pipeline.py:714-716``),
* cache-hit ratio is a real counter (the reference hardcoded 0.75,
  ``embedding_pipeline.py:695-698``).

Kept semantics: md5-keyed embedding cache with evict-to-newest-80%
(``embedding_pipeline.py:652-670``), per-request ``EmbeddingResult`` list,
``create_rag_documents`` conversion (``:720-742``), rolling
processing-time stats.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from modular_rag_system_tpu_torch.chunker import TextChunker
from modular_rag_system_tpu_torch.types import Chunk, Document, EmbeddingResult


class EmbeddingPipeline:
    def __init__(
        self,
        encoder,
        chunker: Optional[TextChunker] = None,
        cache_size: int = 4096,
    ) -> None:
        self.encoder = encoder
        self.chunker = chunker or TextChunker(
            token_counter=getattr(encoder, "token_count", None)
        )
        self.cache_size = cache_size
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.stats: Dict[str, Any] = {
            "total_requests": 0,
            "total_chunks": 0,
            "cache_hits": 0,
            "cache_misses": 0,
        }
        self._times: deque = deque(maxlen=100)

    # ------------------------------------------------------------------
    @staticmethod
    def _key(text: str) -> str:
        return hashlib.md5(text.encode("utf-8")).hexdigest()

    def _cache_put(self, key: str, emb: np.ndarray) -> None:
        self._cache[key] = emb
        self._cache.move_to_end(key)
        if len(self._cache) > self.cache_size:
            # evict oldest down to 80% (reference embedding_pipeline.py:652-670)
            target = int(self.cache_size * 0.8)
            while len(self._cache) > target:
                self._cache.popitem(last=False)

    # ------------------------------------------------------------------
    def process_content(
        self,
        content: str,
        content_type: str = "document",
        metadata: Optional[Dict[str, Any]] = None,
    ) -> List[EmbeddingResult]:
        t0 = time.perf_counter()
        self.stats["total_requests"] += 1
        chunks = self.chunker.chunk_text(content, content_type)
        if not chunks:
            return []
        embeddings = self._embed_chunks([c.text for c in chunks])
        dt = time.perf_counter() - t0
        self._times.append(dt)
        self.stats["total_chunks"] += len(chunks)
        results = []
        for chunk, emb in zip(chunks, embeddings):
            results.append(
                EmbeddingResult(
                    content=chunk.text,
                    embedding=emb,
                    model_used=getattr(self.encoder, "name", "unknown"),
                    processing_time=dt / len(chunks),
                    content_hash=self._key(chunk.text),
                    chunk_info={
                        "index": chunk.index,
                        "total": chunk.total,
                        "token_count": chunk.token_count,
                        "content_type": content_type,
                        **(metadata or {}),
                    },
                )
            )
        return results

    def _embed_chunks(self, texts: List[str]) -> List[np.ndarray]:
        keys = [self._key(t) for t in texts]
        out: List[Optional[np.ndarray]] = [None] * len(texts)
        miss_idx: List[int] = []
        for i, k in enumerate(keys):
            hit = self._cache.get(k)
            if hit is not None:
                self._cache.move_to_end(k)
                out[i] = hit
                self.stats["cache_hits"] += 1
            else:
                miss_idx.append(i)
                self.stats["cache_misses"] += 1
        if miss_idx:
            # ONE batched forward for all misses, deduped within the batch
            uniq: Dict[str, int] = {}
            uniq_texts: List[str] = []
            for i in miss_idx:
                if keys[i] not in uniq:
                    uniq[keys[i]] = len(uniq_texts)
                    uniq_texts.append(texts[i])
            embs = np.asarray(self.encoder.encode(uniq_texts))
            for i in miss_idx:
                emb = embs[uniq[keys[i]]]
                out[i] = emb
                self._cache_put(keys[i], emb)
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------
    def batch_process(
        self, requests: Sequence[Dict[str, Any]]
    ) -> List[List[EmbeddingResult]]:
        """Process many (content, content_type, metadata) dicts.

        All chunks across all requests share one encode call per cache-miss
        set — the whole batch is one device round-trip.
        """
        all_chunks: List[Chunk] = []
        spans: List[int] = []
        for req in requests:
            chunks = self.chunker.chunk_text(
                req["content"], req.get("content_type", "document")
            )
            spans.append(len(chunks))
            all_chunks.extend(chunks)
        t0 = time.perf_counter()
        embeddings = self._embed_chunks([c.text for c in all_chunks]) if all_chunks else []
        dt = time.perf_counter() - t0
        self.stats["total_requests"] += len(requests)
        self.stats["total_chunks"] += len(all_chunks)
        self._times.append(dt)

        results: List[List[EmbeddingResult]] = []
        pos = 0
        for req, n in zip(requests, spans):
            rs = []
            for chunk, emb in zip(all_chunks[pos : pos + n], embeddings[pos : pos + n]):
                rs.append(
                    EmbeddingResult(
                        content=chunk.text,
                        embedding=emb,
                        model_used=getattr(self.encoder, "name", "unknown"),
                        processing_time=dt / max(len(all_chunks), 1),
                        content_hash=self._key(chunk.text),
                        chunk_info={
                            "index": chunk.index,
                            "total": chunk.total,
                            "token_count": chunk.token_count,
                            "content_type": chunk.content_type,
                            **(req.get("metadata") or {}),
                        },
                    )
                )
            results.append(rs)
            pos += n
        return results

    # ------------------------------------------------------------------
    def create_rag_documents(
        self,
        results: Sequence[EmbeddingResult],
        source: str = "unknown",
        importance: float = 1.0,
    ) -> List[Document]:
        """EmbeddingResult -> Document (reference ``embedding_pipeline.py:720-742``)."""
        return [
            Document(
                content=r.content,
                embedding=r.embedding,
                source=source,
                content_type=r.chunk_info.get("content_type", "document"),
                importance=importance,
                metadata={
                    "model_used": r.model_used,
                    "content_hash": r.content_hash,
                    "chunk_index": r.chunk_info.get("index", 0),
                    "chunk_total": r.chunk_info.get("total", 1),
                },
            )
            for r in results
        ]

    # ------------------------------------------------------------------
    def get_stats(self) -> Dict[str, Any]:
        hits, misses = self.stats["cache_hits"], self.stats["cache_misses"]
        total = hits + misses
        return {
            **self.stats,
            "cache_size": len(self._cache),
            "cache_hit_ratio": (hits / total) if total else 0.0,  # REAL ratio
            "avg_processing_time": (sum(self._times) / len(self._times)) if self._times else 0.0,
            "encoder": getattr(self.encoder, "name", "unknown"),
        }


class MicroBatcher:
    """Micro-batcher between capture adapters and the engine.

    Parity with the reference ``KeystrokeEmbeddingProcessor``
    (``embedding_pipeline.py:745-848``): buffers incoming (content,
    metadata) items and flushes them as ONE ``batch_process`` +
    ``add_documents`` call when ``batch_size`` items accumulate or
    ``flush_timeout_s`` elapses.  A background poll thread handles the
    timeout path; ``flush()`` is the synchronous entry used by tests and
    shutdown.
    """

    def __init__(
        self,
        pipeline: EmbeddingPipeline,
        engine,
        batch_size: int = 5,
        flush_timeout_s: float = 30.0,
        poll_interval_s: float = 5.0,
        buffer_cap: int = 100,
    ) -> None:
        self.pipeline = pipeline
        self.engine = engine
        self.batch_size = batch_size
        self.flush_timeout_s = flush_timeout_s
        self.poll_interval_s = poll_interval_s
        self._buffer: deque = deque(maxlen=buffer_cap)
        self._last_flush = time.time()
        self._lock = threading.RLock()
        self._thread = None
        self._stop = threading.Event()
        self.stats = {"items": 0, "flushes": 0, "documents_added": 0}

    def add(self, content: str, metadata: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self._buffer.append(
                {"content": content, "metadata": metadata or {},
                 "content_type": (metadata or {}).get("content_type", "keystroke")}
            )
            self.stats["items"] += 1
            if len(self._buffer) >= self.batch_size:
                self._flush_locked()

    def flush(self) -> int:
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._buffer:
            return 0
        items, self._buffer = list(self._buffer), deque(maxlen=self._buffer.maxlen)
        self._last_flush = time.time()
        results = self.pipeline.batch_process(items)
        docs = []
        for item, rs in zip(items, results):
            docs.extend(
                self.pipeline.create_rag_documents(
                    rs, source=item["metadata"].get("application", item["content_type"])
                )
            )
        if docs:
            self.engine.add_documents(docs)
        self.stats["flushes"] += 1
        self.stats["documents_added"] += len(docs)
        return len(docs)

    # ------------------------------------------------------------------
    def start_background(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_interval_s):
                with self._lock:
                    if self._buffer and time.time() - self._last_flush >= self.flush_timeout_s:
                        self._flush_locked()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.flush()
