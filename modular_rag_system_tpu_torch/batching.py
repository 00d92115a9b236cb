"""Server-side query micro-batching.

HTTP clients send one query per request, while the device search of a
batch costs little more than that of one query.  ``QueryBatcher``
coalesces concurrent single queries into one ``engine.query_batch``
dispatch: a submit parks the caller on an event; the collector flushes a
group when it reaches ``max_batch`` or its oldest request has waited
``window_ms``.

Requests are grouped by their retrieval parameters (max_results,
threshold, filters) so every member of a flush shares one search;
``query()``/``query_batch()`` parity makes the coalesced result
identical to the sequential one.

Coalescing saves device-serial search time, not round-trip latency: on a
small corpus, where a search is short next to the host's work, unbatched
threads can pipeline better, so the serving default is off
(``serving.query_batch_window_ms = 0``).  Several flushes run at once
(``flush_workers``), so the engine is called from several threads.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple


class _Pending:
    __slots__ = ("text", "event", "result", "error")

    def __init__(self, text: str) -> None:
        self.text = text
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class QueryBatcher:
    """Coalesces concurrent ``submit`` calls into ``engine.query_batch``."""

    def __init__(self, engine, window_ms: float = 4.0,
                 max_batch: int = 256, flush_workers: int = 4) -> None:
        """``flush_workers`` flushes run CONCURRENTLY: a flush pays the
        host's encode and post-processing beside its device search, so
        serializing them caps throughput at 1/flush-latency regardless
        of batch size.  Coalescing + pipelining keeps the device busy
        while earlier flushes drain."""
        self.engine = engine
        self.window_s = max(window_ms, 0.0) / 1000.0
        self.max_batch = max(max_batch, 1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # param-key -> (first-enqueue time, pending list)
        self._groups: Dict[Tuple, Tuple[float, List[_Pending]]] = {}
        self._stop = False
        self.stats = {"queries": 0, "flushes": 0, "max_flush": 0}
        self._pool = ThreadPoolExecutor(
            max_workers=max(flush_workers, 1),
            thread_name_prefix="query-batch-flush",
        )
        self._thread = threading.Thread(
            target=self._run, name="query-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, text: str, max_results: int = 5,
               similarity_threshold: Optional[float] = None,
               source_filters: Optional[Tuple[str, ...]] = None,
               metadata_filters: Optional[Tuple[Tuple[str, Any], ...]] = None,
               timeout_s: float = 600.0):
        """Blocking single-query submit; returns a RetrievalResult.

        ``timeout_s`` guards against a dead collector, not slow work:
        the first query of a process builds the CUDA kernels, and a
        flush can wait behind an index rebuild."""
        key = (max_results, similarity_threshold, source_filters,
               metadata_filters)
        p = _Pending(text)
        with self._cond:
            if self._stop:
                # fail fast rather than parking for the full timeout: the
                # collector has already exited and will never flush us
                raise RuntimeError("QueryBatcher is closed")
            now = time.monotonic()
            first, lst = self._groups.get(key, (now, []))
            lst.append(p)
            self._groups[key] = (first, lst)
            self.stats["queries"] += 1
            self._cond.notify()
        if not p.event.wait(timeout_s):
            raise TimeoutError("query batch dispatch timed out")
        if p.error is not None:
            raise p.error
        return p.result

    # ------------------------------------------------------------------
    def _due(self, now: float):
        """(groups to flush now, seconds until the next deadline)."""
        ready = []
        next_deadline = None
        for key, (first, lst) in self._groups.items():
            deadline = first + self.window_s
            if len(lst) >= self.max_batch or now >= deadline:
                ready.append(key)
            elif next_deadline is None or deadline < next_deadline:
                next_deadline = deadline
        return ready, next_deadline

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._stop:
                        return
                    now = time.monotonic()
                    ready, next_deadline = self._due(now)
                    if ready:
                        batches = [(k, self._groups.pop(k)[1]) for k in ready]
                        break
                    self._cond.wait(
                        timeout=None if next_deadline is None
                        else max(next_deadline - now, 0.0)
                    )
            for key, lst in batches:
                # a group can exceed max_batch between collector wakeups
                # (submit appends while a flush window is open); split so
                # device batch shapes stay bounded by max_batch
                for i in range(0, len(lst), self.max_batch):
                    self._pool.submit(self._flush, key,
                                      lst[i:i + self.max_batch])

    def _flush(self, key: Tuple, lst: List[_Pending]) -> None:
        max_results, threshold, src, meta = key
        try:
            results = self.engine.query_batch(
                [p.text for p in lst],
                max_results=max_results,
                similarity_threshold=threshold,
                source_filters=list(src) if src else None,
                metadata_filters=dict(meta) if meta else None,
            )
            for p, r in zip(lst, results):
                p.result = r
        except BaseException as exc:  # noqa: BLE001 - delivered to callers
            for p in lst:
                p.error = exc
        finally:
            with self._lock:  # flushes run concurrently in the pool
                self.stats["flushes"] += 1
                self.stats["max_flush"] = max(self.stats["max_flush"],
                                              len(lst))
            for p in lst:
                p.event.set()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        # allow in-flight flushes (possibly building kernels) to finish —
        # killing the interpreter mid-device-call aborts the process
        self._thread.join(timeout=60)
        # the collector exits without flushing: fail any pending submit
        # immediately instead of leaving it parked for its full timeout
        # (submit racing close can still enqueue before _stop lands)
        with self._cond:
            orphans, self._groups = self._groups, {}
        err = RuntimeError("QueryBatcher closed before dispatch")
        for _first, lst in orphans.values():
            for p in lst:
                p.error = err
                p.event.set()
        self._pool.shutdown(wait=True, cancel_futures=False)
