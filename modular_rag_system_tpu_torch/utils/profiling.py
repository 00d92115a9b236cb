"""Profiling, timing and the port's tracer.

The reference had only ad-hoc wall-clock fields and two hardcoded fake
metrics (cache-hit ratio 0.75 / 0.85 — ``embedding_pipeline.py:695-698``,
``rag_query_interface.py:828``).  Here:

* ``TimingRegistry`` — cheap named timers with rolling windows (count,
  mean, p50, p99); the tracer keeps its per-name windows in one,
* ``TRACER`` — the process's one ``Tracer``: spans and counters at the
  layer boundaries of the write path (``RAGEngine.add_documents``), the
  trainer step (``ContrastiveTrainer.step``), ModernBERT's two kinds
  of attention layer (``models/modernbert.py``) and DeepSeek-V3's causal
  attention, router and experts (``models/deepseek_v3.py``).  Off by default
  (``TRACER.enable()`` / ``TRACER.disable()``); ``TRACER.stats()``
  summarises what it recorded,
* ``device_trace`` — a context manager around ``torch.profiler`` that
  dumps a Chrome trace (``chrome://tracing``, Perfetto) of the host ops
  and, on a card, the CUDA kernels, for kernel-level analysis; with the
  tracer on, its layer spans lie on the same timeline.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional, Tuple


class TimingRegistry:
    def __init__(self, window: int = 200) -> None:
        self._times: Dict[str, Deque[float]] = defaultdict(lambda: deque(maxlen=window))
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def track(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)
        self._counts[name] += 1

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, window in self._times.items():
            if not window:
                continue
            xs = sorted(window)
            out[name] = {
                "count": self._counts[name],
                "avg_s": sum(xs) / len(xs),
                "p50_s": xs[len(xs) // 2],
                "p99_s": xs[min(len(xs) - 1, int(len(xs) * 0.99))],
            }
        return out


# The layer spans, which also enter ``torch.profiler.record_function``
# while a profile records.  Root spans ("engine.add_documents",
# "trainer.step") and "gc" stay in memory: a root covers a whole call, and
# would claim every idle gap of the device under it.
TIMELINE_SPANS = frozenset({
    "trainer.tokenize", "trainer.forward", "trainer.backward", "trainer.update",
    "trainer.readback",
    "encoder.tokenize", "encoder.forward", "encoder.attn_global", "encoder.attn_local",
    "encoder.attn_causal", "encoder.moe_route", "encoder.moe_experts",
    "store.lookup", "store.rows", "store.write", "store.commit",
    "index.add",
})


# spans kept in memory: a few minutes of ingest or training with its
# collections
_RING = 65536


class Span(NamedTuple):
    """One closed span: ``perf_counter_ns`` start and end, the thread's
    ident, the span's id, its parent's id and its root's id (None outside
    any root); ``gen`` is a garbage collection's generation."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    root: Optional[int]
    gen: Optional[int] = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("tracer", "name", "is_root", "id", "parent", "root", "start", "rf")

    def __init__(self, tracer: "Tracer", name: str, is_root: bool) -> None:
        self.tracer, self.name, self.is_root = tracer, name, is_root

    def __enter__(self) -> None:
        t = self.tracer
        stack = t._stack()
        top = stack[-1] if stack else None
        self.id = next(t._ids)
        self.parent = None if top is None else top.id
        if top is not None and top.root is not None:
            self.root = top.root
        else:
            self.root = self.id if self.is_root else None
        self.rf = None
        if not self.is_root and t._profiling():
            self.rf = t._record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        t = self.tracer
        t._stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        t._close(Span(self.name, self.start, end, threading.get_ident(), self.id,
                      self.parent, self.root))
        return False


class Tracer:
    """Spans and counters at the port's layer boundaries.

    Off, ``span``, ``root`` and ``count`` test one flag and return: a span
    is a shared no-op context manager.  On, each span keeps its name,
    ``perf_counter_ns`` start and end, thread and parent in a ring of the
    last ``_RING`` spans, with running totals per name and a
    ``TimingRegistry`` window; a counter keeps its running sum.  No span
    synchronizes the device: device time comes from the device trace,
    beside which a layer span lies while a ``torch.profiler`` profile
    records.  On, the tracer also times every garbage collection as a
    "gc" span and counts gen-2 collections ("gc.gen2")."""

    def __init__(self) -> None:
        self.on = False
        self._ring: Deque[Span] = deque(maxlen=_RING)
        self._timings = TimingRegistry()
        self._totals: Dict[str, List[int]] = defaultdict(lambda: [0, 0])  # ns, spans
        self._counters: Dict[str, int] = defaultdict(int)
        # reentrant: a collection's callback may run inside _close
        self._lock = threading.RLock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._gc_start = 0
        self._gc_cb = self._on_gc
        self._profiling = None
        self._record_function = None

    # -- switching -------------------------------------------------------
    def enable(self) -> None:
        if self.on:
            return
        import torch
        from torch.profiler import record_function

        self._profiling = torch.autograd._profiler_enabled
        self._record_function = record_function
        gc.callbacks.append(self._gc_cb)
        self.on = True

    def disable(self) -> None:
        if not self.on:
            return
        self.on = False
        gc.callbacks.remove(self._gc_cb)

    def reset(self) -> None:
        """Forget every span and counter recorded so far."""
        with self._lock:
            self._ring.clear()
            self._timings = TimingRegistry()
            self._totals.clear()
            self._counters.clear()

    # -- recording -------------------------------------------------------
    def span(self, name: str):
        """A layer span (one of ``TIMELINE_SPANS``) as a context manager."""
        if not self.on:
            return _NO_SPAN
        return _OpenSpan(self, name, False)

    def root(self, name: str):
        """A root span: the spans opened under it share its id."""
        if not self.on:
            return _NO_SPAN
        return _OpenSpan(self, name, True)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        with self._lock:
            self._counters[name] += n

    def _stack(self) -> List[_OpenSpan]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, span: Span) -> None:
        dur = span.end_ns - span.start_ns
        with self._lock:
            self._ring.append(span)
            self._timings.record(span.name, dur / 1e9)
            total = self._totals[span.name]
            total[0] += dur
            total[1] += 1

    def _on_gc(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
            return
        end = time.perf_counter_ns()
        stack = self._stack()
        top = stack[-1] if stack else None
        gen = info["generation"]
        self._close(Span("gc", self._gc_start, end, threading.get_ident(), next(self._ids),
                         None if top is None else top.id, None if top is None else top.root,
                         gen))
        if gen == 2:
            self.count("gc.gen2")

    # -- reading ---------------------------------------------------------
    def spans(self) -> List[Span]:
        """The ring's spans, in the order they closed."""
        with self._lock:
            return list(self._ring)

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """{span name: (seconds spent in it, spans closed)} since the last
        reset."""
        with self._lock:
            return {k: (ns / 1e9, n) for k, (ns, n) in self._totals.items()}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def stats(self) -> Dict[str, Dict]:
        """{"spans": {name: count, avg_s, p50_s, p99_s (over the last 200
        spans of the name), total_s}, "counters": {name: sum}}."""
        with self._lock:
            spans = self._timings.stats()
            for name, s in spans.items():
                s["total_s"] = self._totals[name][0] / 1e9
            return {"spans": spans, "counters": dict(self._counters)}


TRACER = Tracer()


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``log_dir/trace.json``;
    CUDA activity is recorded when ``device`` is a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
