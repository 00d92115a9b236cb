"""Profiling + timing utilities.

The reference had only ad-hoc wall-clock fields and two hardcoded fake
metrics (cache-hit ratio 0.75 / 0.85 — ``embedding_pipeline.py:695-698``,
``rag_query_interface.py:828``).  Here:

* ``TimingRegistry`` — cheap named timers with rolling windows, used by
  engine/pipeline stats (all numbers real),
* ``device_trace`` — a context manager around ``torch.profiler`` that
  dumps a Chrome trace (``chrome://tracing``, Perfetto) of the host ops
  and, on a card, the CUDA kernels, for kernel-level analysis.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Deque, Dict, Iterator


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
