"""Core data model.

Mirrors the reference's data types (``ollama_rag_system.py:46-93``,
``embedding_pipeline.py:43-69``, ``rag_query_interface.py:31-66``) with two
deliberate fixes:

* Document IDs are pure content hashes (sha256 of content+source), NOT
  md5(content)+md5(timestamp) (``ollama_rag_system.py:64-68``) — so
  re-ingesting the same content is an idempotent upsert.
* There is ONE embedding space: ingest and query go through the same
  encoder.  (The reference used two independent embedders that could emit
  different dimensions and silently score 0.0,
  ``ollama_rag_system.py:199-222``.)
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

CONTENT_TYPES = ("document", "keystroke", "ocr", "query")


def content_id(content: str, source: str = "") -> str:
    """Stable content-hash ID (idempotent upsert key)."""
    h = hashlib.sha256()
    h.update(source.encode("utf-8"))
    h.update(b"\x00")
    h.update(content.encode("utf-8"))
    return h.hexdigest()[:32]


@dataclass
class Document:
    """Unit of storage (reference ``RAGDocument``, ``ollama_rag_system.py:46-71``)."""

    content: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    source: str = "unknown"
    content_type: str = "document"
    timestamp: float = field(default_factory=time.time)
    importance: float = 1.0
    access_count: int = 0
    embedding: Optional[np.ndarray] = None
    id: str = ""

    def __post_init__(self) -> None:
        if not self.id:
            self.id = content_id(self.content, self.source)

    def to_dict(self, include_embedding: bool = False) -> Dict[str, Any]:
        d = {
            "id": self.id,
            "content": self.content,
            "metadata": self.metadata,
            "source": self.source,
            "content_type": self.content_type,
            "timestamp": self.timestamp,
            "importance": self.importance,
            "access_count": self.access_count,
        }
        if include_embedding and self.embedding is not None:
            d["embedding"] = np.asarray(self.embedding).tolist()
        return d


@dataclass
class Query:
    """Query spec (reference ``RAGQuery``, ``ollama_rag_system.py:74-83``)."""

    text: str
    context: Dict[str, Any] = field(default_factory=dict)
    max_results: int = 5
    similarity_threshold: float = 0.7
    time_weight: float = 0.1
    source_filters: Optional[List[str]] = None
    metadata_filters: Optional[Dict[str, Any]] = None


@dataclass
class RetrievalResult:
    """Retrieval result (reference ``RAGResult``, ``ollama_rag_system.py:86-93``)."""

    documents: List[Document]
    similarities: List[float]
    query_embedding: Optional[np.ndarray]
    retrieval_time: float
    total_documents_searched: int


@dataclass
class Chunk:
    """One retrieval unit produced by the chunker."""

    text: str
    index: int
    total: int
    content_type: str
    token_count: int
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EmbeddingResult:
    """Per-chunk embedding output (reference ``embedding_pipeline.py:57-69``)."""

    content: str
    embedding: np.ndarray
    model_used: str
    processing_time: float
    content_hash: str
    chunk_info: Dict[str, Any] = field(default_factory=dict)


def as_matrix(embeddings: Sequence[np.ndarray], dim: int) -> np.ndarray:
    """Stack embeddings into an (N, dim) float32 matrix, validating dims."""
    if not embeddings:
        return np.zeros((0, dim), dtype=np.float32)
    mat = np.stack([np.asarray(e, dtype=np.float32) for e in embeddings])
    if mat.shape[1] != dim:
        raise ValueError(f"embedding dim {mat.shape[1]} != index dim {dim}")
    return mat
