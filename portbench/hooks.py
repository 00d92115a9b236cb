"""The traced run's instruments: host spans around calls into the
program's layers, work counts taken from those calls' arguments, and the
reduction of a ``torch.profiler`` trace to device busy time, kernel time
by name and idle gaps.

A hook wraps one method of one object (an engine's store, its encoder's
tokenizer, ...) or one module function.  The wrapper times the call
(synchronizing the device before and after where the layer launches
device work), marks it in the profiler's timeline with its span name,
and hands the call's arguments and result to the metric readers that
asked for them.  Hooks record only while ``active`` is set: set-up and
the reference run unrecorded.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple


class Recorder:
    def __init__(self, device) -> None:
        self.device = device
        self.active = False
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.work: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._hooks: Dict[Tuple[int, str], "_Hook"] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def hook(self, owner: Any, attr: str, span: Optional[str] = None, sync: bool = False,
             on_call: Optional[Callable] = None) -> None:
        """Wrap ``owner.attr``: time it as ``span`` (if given) and call
        ``on_call(recorder, args, kwargs, result)`` after each call.  One
        wrapper serves every metric that hooks the same attribute."""
        key = (id(owner), attr)
        h = self._hooks.get(key)
        if h is None:
            h = self._hooks[key] = _Hook(self, owner, attr)
        if span is not None:
            h.span = span
        h.sync = h.sync or sync
        if on_call is not None:
            h.on_call.append(on_call)

    def add(self, table: str, key: str, value: float) -> None:
        with self._lock:
            getattr(self, table)[key] += value

    def span_total(self, name: str) -> Optional[float]:
        """Seconds spent in span ``name``, or None when it never ran."""
        vals = self.spans.get(name)
        return sum(vals) if vals else None

    def restore(self) -> None:
        for h in self._hooks.values():
            setattr(h.owner, h.attr, h.orig)
        self._hooks.clear()


class _Hook:
    def __init__(self, rec: Recorder, owner: Any, attr: str) -> None:
        self.rec, self.owner, self.attr = rec, owner, attr
        self.orig = getattr(owner, attr)
        self.span: Optional[str] = None
        self.sync = False
        self.on_call: List[Callable] = []
        setattr(owner, attr, self)

    def __call__(self, *args, **kwargs):
        rec = self.rec
        if not rec.active:
            return self.orig(*args, **kwargs)
        from torch.profiler import record_function

        if self.span is None:
            out = self.orig(*args, **kwargs)
        else:
            if self.sync:
                rec._sync()
            t0 = time.perf_counter()
            with record_function(self.span):
                out = self.orig(*args, **kwargs)
                if self.sync:
                    rec._sync()
            dt = time.perf_counter() - t0
            with rec._lock:
                rec.spans[self.span].append(dt)
        for fn in self.on_call:
            fn(rec, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# profiler trace
def device_intervals(prof, annotations) -> Tuple[List[Tuple[float, float]],
                                                  Dict[str, Tuple[float, int]]]:
    """(device activity intervals in microseconds, sorted; {kernel name:
    (device seconds, launches)}) of a profile.  Only device-side events
    count (a host op's device time repeats its kernels'), and not the
    device-side copies of the hooks' spans (``annotations``), which cover
    the idle time inside a span too."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.name in annotations:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        t, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (t + (e - s) / 1e6, n + 1)
    spans.sort()
    return spans, by_name


def union_busy(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy microseconds as the union of the intervals, the idle gaps
    between them as (start, end))."""
    busy, end, gaps = 0.0, None, []
    for s, e in spans:
        if end is None:
            busy, end = e - s, e
            continue
        if s > end:
            gaps.append((end, s))
        busy += max(e - max(s, end), 0.0)
        end = max(end, e)
    return busy, gaps


def host_spans(prof, names) -> List[Tuple[float, float, str]]:
    """The timeline's intervals of the hooks' record_function spans."""
    from torch.autograd import DeviceType

    out = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
           if ev.device_type == DeviceType.CPU and ev.name in names]
    out.sort()
    return out


def name_gap(gap: Tuple[float, float], spans: List[Tuple[float, float, str]]) -> str:
    """The hook span that covers most of an idle gap, else "other host
    work"."""
    s, e = gap
    cover: Dict[str, float] = defaultdict(float)
    for a, b, name in spans:
        if a >= e:
            break
        if b > s:
            cover[name] += min(b, e) - max(a, s)
    if not cover:
        return "other host work"
    return max(cover.items(), key=lambda kv: kv[1])[0]


def summarize(prof, window_s: float, span_names) -> Dict[str, Any]:
    """busy_s, window_s, kernel time by name and the breakdown of the
    contract's last line (at most 10 entries a list)."""
    span_names = set(span_names)
    spans, by_name = device_intervals(prof, span_names)
    busy_us, gaps = union_busy(spans)
    named = host_spans(prof, span_names)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = [[name_gap(g, named), (g[1] - g[0]) / 1e6] for g in gaps[:10]]
    ops = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "kernels": by_name,
            "breakdown": {"device_ops": [[n, t] for n, (t, _) in ops], "idle_gaps": idle}}


# ---------------------------------------------------------------------------
# what the metric readers share
def span_ms_per_unit(run, rec: Recorder, span: str) -> Optional[float]:
    """Milliseconds in ``span`` per unit of the window's work (a call, a
    step), or None when the span never ran."""
    t = rec.span_total(span)
    if t is None or not getattr(run, "units", 0):
        return None
    return t * 1e3 / run.units


def idle_share(trace) -> Optional[float]:
    """The device's idle share of the profiled part of the window, in
    percent."""
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def dense_of(engine):
    return getattr(engine.encoder, "dense", engine.encoder)


def count_forward(run, rec: Recorder, engine) -> None:
    """Encoder forward FLOPs over the real tokens of every forward, into
    ``rec.work["bf16"]``; the forward's span is "forward"."""
    from portbench.checks import arch_of
    from portbench.roofline.encoder import forward_flops

    arch = arch_of(run.config)

    def on_call(rec, args, kwargs, out):
        mask = args[1] if len(args) > 1 else kwargs["mask"]
        rec.add("work", "bf16", forward_flops(arch, (int(n) for n in mask.sum(axis=1))))

    rec.hook(dense_of(engine), "forward_tokens", span="forward", sync=True, on_call=on_call)


def mfu(run, rec: Recorder, trace) -> Optional[float]:
    """The window's counted work at each kind's peak, over the window's
    whole wall time, in percent."""
    if run.spec is None or not rec.work:
        return None
    t = sum(ops / run.spec[kind] for kind, ops in rec.work.items() if kind in ("bf16", "int8"))
    return 100.0 * t / run.window_s if t > 0 else None
