"""SQLite-backed document/metadata store.

This replaces the reference's three-way storage backend
(ChromaDB | SQLite-with-pickled-embeddings | dead FAISS path,
``ollama_rag_system.py:225-554``) with a single host-side *metadata* store.
Embeddings do NOT live here — they live in the device index (device matrix);
this store maps dense index rows <-> documents and owns persistence,
filtering and bookkeeping (importance / access_count, reference
``ollama_rag_system.py:46-71``).

Key properties:

* content-hash IDs give idempotent upsert (re-ingesting a file is a
  no-op, matching Chroma upsert semantics ``ollama_rag_system.py:326``),
* ``row_idx`` is the dense append-order row in the device embedding
  matrix, so search results (row ids) resolve to documents in O(k),
* no search cap: the reference silently scanned only the newest 1000 rows
  (``ollama_rag_system.py:474``); here search coverage is the whole index,
* ``delete_older_than`` actually deletes (the reference's
  ``cleanup_old_documents`` only logged, ``ollama_rag_system.py:843-850``).
"""

from __future__ import annotations

import gzip
import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from modular_rag_system_tpu_torch.types import Document
from modular_rag_system_tpu_torch.utils.profiling import TRACER

# row ids bound to one SELECT or UPDATE ... IN (...)
_IN_BATCH = 30_000

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    row_idx      INTEGER PRIMARY KEY,
    id           TEXT UNIQUE NOT NULL,
    content      TEXT NOT NULL,
    content_type TEXT NOT NULL DEFAULT 'document',
    source       TEXT NOT NULL DEFAULT 'unknown',
    timestamp    REAL NOT NULL,
    importance   REAL NOT NULL DEFAULT 1.0,
    access_count INTEGER NOT NULL DEFAULT 0,
    deleted      INTEGER NOT NULL DEFAULT 0,
    metadata     TEXT NOT NULL DEFAULT '{}'
);
CREATE INDEX IF NOT EXISTS idx_docs_ts ON documents(timestamp);
CREATE INDEX IF NOT EXISTS idx_docs_source ON documents(source);
"""


class DocumentStore:
    def __init__(self, storage_path: str = "rag_storage") -> None:
        self.root = Path(storage_path)
        self.root.mkdir(parents=True, exist_ok=True)
        self.db_path = self.root / "documents.db"
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(str(self.db_path), check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # NORMAL is durable enough under WAL and avoids an fsync per
        # commit (the per-query access_count bump commits every query)
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    # ------------------------------------------------------------------
    def upsert_batch(self, docs: Sequence[Document]) -> List[Tuple[int, str]]:
        """Insert documents; returns [(row_idx, status)] per doc.

        Existing ids (same content+source hash) keep their row and get
        their metadata/timestamp refreshed — idempotent re-ingest.

        Returns [(row_idx, status)] where status is "new", "existing" or
        "resurrected" (a previously tombstoned doc brought back: the
        caller must restore its zeroed index row).
        """
        out: List[Tuple[int, str]] = []
        with self._lock:
            with TRACER.span("store.lookup"):
                cur = self._conn.cursor()
                r = cur.execute("SELECT MAX(row_idx) FROM documents").fetchone()[0]
                next_row = 0 if r is None else int(r) + 1
                # one batched lookup + executemany instead of per-doc
                # SELECT/INSERT round trips (the loop dominated bulk ingest)
                existing: Dict[str, Tuple[int, int]] = {}
                ids = [d.id for d in docs]
                for i in range(0, len(ids), 500):
                    chunk = ids[i : i + 500]
                    qmarks = ",".join("?" * len(chunk))
                    for rid, ridx, deleted in cur.execute(
                        f"SELECT id, row_idx, deleted FROM documents "
                        f"WHERE id IN ({qmarks})",
                        chunk,
                    ).fetchall():
                        existing[rid] = (int(ridx), int(deleted))
            with TRACER.span("store.rows"):
                updates = []
                inserts = []
                seen_new: Dict[str, int] = {}
                seen_resurrected: set = set()
                for d in docs:
                    hit = existing.get(d.id)
                    if hit is None and d.id in seen_new:
                        # duplicate within this batch: first occurrence wins
                        out.append((seen_new[d.id], "existing"))
                        continue
                    if hit is not None:
                        updates.append(
                            (json.dumps(d.metadata), d.timestamp, d.importance, d.id)
                        )
                        # only the FIRST occurrence of a tombstoned id counts
                        # as resurrected (the caller rewrites that index row
                        # once); later duplicates are plain updates
                        if hit[1] and d.id not in seen_resurrected:
                            seen_resurrected.add(d.id)
                            out.append((hit[0], "resurrected"))
                        else:
                            out.append((hit[0], "existing"))
                    else:
                        inserts.append(
                            (
                                next_row,
                                d.id,
                                d.content,
                                d.content_type,
                                d.source,
                                d.timestamp,
                                d.importance,
                                json.dumps(d.metadata),
                            )
                        )
                        seen_new[d.id] = next_row
                        out.append((next_row, "new"))
                        next_row += 1
            with TRACER.span("store.write"):
                if updates:
                    cur.executemany(
                        "UPDATE documents SET metadata = ?, timestamp = ?, "
                        "importance = ?, deleted = 0 WHERE id = ?",
                        updates,
                    )
                if inserts:
                    cur.executemany(
                        "INSERT INTO documents "
                        "(row_idx, id, content, content_type, source, timestamp, "
                        "importance, metadata) VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                        inserts,
                    )
            with TRACER.span("store.commit"):
                self._conn.commit()
        return out

    # ------------------------------------------------------------------
    def get_by_rows(self, rows: Iterable[int], bump_access: bool = True) -> List[Optional[Document]]:
        rows = list(rows)
        if not rows:
            return []
        fetched = []
        with self._lock:
            cur = self._conn.cursor()
            # batches under SQLite's default limit of 32,766 bound
            # parameters: a deep refill at Q=256 fetches millions of rows
            for s in range(0, len(rows), _IN_BATCH):
                part = rows[s:s + _IN_BATCH]
                qmarks = ",".join("?" * len(part))
                fetched += cur.execute(
                    f"SELECT row_idx, id, content, content_type, source, timestamp, "
                    f"importance, access_count, deleted, metadata FROM documents "
                    f"WHERE row_idx IN ({qmarks})",
                    part,
                ).fetchall()
                if bump_access:
                    cur.execute(
                        f"UPDATE documents SET access_count = access_count + 1 "
                        f"WHERE row_idx IN ({qmarks})",
                        part,
                    )
            if bump_access:
                self._conn.commit()
        by_row = {r[0]: r for r in fetched}
        out: List[Optional[Document]] = []
        for ridx in rows:
            r = by_row.get(ridx)
            if r is None or r[8]:
                out.append(None)
            else:
                out.append(self._to_doc(r))
        return out

    def get_by_id(self, doc_id: str) -> Optional[Document]:
        with self._lock:
            r = self._conn.execute(
                "SELECT row_idx, id, content, content_type, source, timestamp, "
                "importance, access_count, deleted, metadata FROM documents WHERE id = ?",
                (doc_id,),
            ).fetchone()
        return None if r is None or r[8] else self._to_doc(r)

    @staticmethod
    def _to_doc(r) -> Document:
        return Document(
            id=r[1],
            content=r[2],
            content_type=r[3],
            source=r[4],
            timestamp=r[5],
            importance=r[6],
            access_count=r[7],
            metadata=json.loads(r[9]),
        )

    # ------------------------------------------------------------------
    def row_of(self, doc_id: str) -> Optional[int]:
        with self._lock:
            r = self._conn.execute(
                "SELECT row_idx FROM documents WHERE id = ?", (doc_id,)
            ).fetchone()
        return None if r is None else int(r[0])

    def count(self, include_deleted: bool = False) -> int:
        q = "SELECT COUNT(*) FROM documents" + ("" if include_deleted else " WHERE deleted = 0")
        with self._lock:
            return int(self._conn.execute(q).fetchone()[0])

    def max_row(self) -> int:
        with self._lock:
            r = self._conn.execute("SELECT MAX(row_idx) FROM documents").fetchone()[0]
        return -1 if r is None else int(r)

    def iter_all(
        self, batch: int = 4096, include_deleted: bool = False
    ) -> Iterable[Tuple[int, Optional[Document]]]:
        """Yield (row_idx, doc) in dense row order, for index rebuild.

        With ``include_deleted`` tombstoned rows are yielded as
        ``(row_idx, None)`` so callers can keep index rows positionally
        aligned (restore MUST use this: skipping deleted rows would shift
        every later embedding by one)."""
        last = -1
        cond = "" if include_deleted else "AND deleted = 0"
        while True:
            with self._lock:
                rows = self._conn.execute(
                    f"SELECT row_idx, id, content, content_type, source, timestamp, "
                    f"importance, access_count, deleted, metadata FROM documents "
                    f"WHERE row_idx > ? {cond} ORDER BY row_idx LIMIT ?",
                    (last, batch),
                ).fetchall()
            if not rows:
                return
            for r in rows:
                yield int(r[0]), (None if r[8] else self._to_doc(r))
            last = int(rows[-1][0])

    # ------------------------------------------------------------------
    def deleted_rows(self) -> np.ndarray:
        with self._lock:
            rows = self._conn.execute(
                "SELECT row_idx FROM documents WHERE deleted = 1"
            ).fetchall()
        return np.array([r[0] for r in rows], dtype=np.int32)

    def delete_ids(self, ids: Sequence[str]) -> int:
        with self._lock:
            cur = self._conn.cursor()
            n = 0
            for i in ids:
                n += cur.execute(
                    "UPDATE documents SET deleted = 1 WHERE id = ? AND deleted = 0", (i,)
                ).rowcount
            self._conn.commit()
        return n

    def delete_older_than(self, cutoff_ts: float) -> int:
        """Real retention (reference stub: ``ollama_rag_system.py:843-850``)."""
        with self._lock:
            n = self._conn.execute(
                "UPDATE documents SET deleted = 1 WHERE timestamp < ? AND deleted = 0",
                (cutoff_ts,),
            ).rowcount
            self._conn.commit()
        return int(n)

    def compact(self) -> List[int]:
        """Drop tombstoned rows and renumber live rows densely.

        Returns the list of OLD row indices in their new dense order, so
        the caller can rebuild the device index by gathering those rows.
        """
        with self._lock:
            cur = self._conn.cursor()
            live = [
                int(r[0])
                for r in cur.execute(
                    "SELECT row_idx FROM documents WHERE deleted = 0 ORDER BY row_idx"
                ).fetchall()
            ]
            cur.execute("DELETE FROM documents WHERE deleted = 1")
            # two-phase renumber to avoid UNIQUE collisions
            for new, old in enumerate(live):
                cur.execute(
                    "UPDATE documents SET row_idx = ? WHERE row_idx = ?",
                    (-(new + 1), old),
                )
            cur.execute("UPDATE documents SET row_idx = -row_idx - 1 WHERE row_idx < 0")
            self._conn.commit()
        return live

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.count()
            by_source = dict(
                self._conn.execute(
                    "SELECT source, COUNT(*) FROM documents WHERE deleted = 0 GROUP BY source"
                ).fetchall()
            )
            by_type = dict(
                self._conn.execute(
                    "SELECT content_type, COUNT(*) FROM documents WHERE deleted = 0 "
                    "GROUP BY content_type"
                ).fetchall()
            )
            span = self._conn.execute(
                "SELECT MIN(timestamp), MAX(timestamp) FROM documents WHERE deleted = 0"
            ).fetchone()
        return {
            "total_documents": total,
            "by_source": by_source,
            "by_content_type": by_type,
            "oldest_timestamp": span[0],
            "newest_timestamp": span[1],
            "db_path": str(self.db_path),
        }

    def export_gzip_json(self, path: str, recent: int = 100) -> str:
        """gzip JSON export (reference ``ollama_rag_system.py:852-869``)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT row_idx, id, content, content_type, source, timestamp, "
                "importance, access_count, deleted, metadata FROM documents "
                "WHERE deleted = 0 ORDER BY timestamp DESC LIMIT ?",
                (recent,),
            ).fetchall()
        payload = {
            "exported_at": time.time(),
            "stats": self.stats(),
            "recent_documents": [self._to_doc(r).to_dict() for r in rows],
        }
        with gzip.open(path, "wt") as f:
            json.dump(payload, f)
        return path

    def close(self) -> None:
        with self._lock:
            self._conn.close()
