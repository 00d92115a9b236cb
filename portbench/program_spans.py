"""What the readers of the program's own spans and counters share.

The program's tracer (``modular_rag_system_tpu_torch/utils/profiling.py``
``TRACER``) is turned on when the first such reader is installed, after
set-up, and its totals are taken after each unit of the window (at every
``run.tick``), so that what runs after the window (the profile's
read-back, the release) is not counted.  Every layer span name the tracer
can put on the profiler's timeline is registered in ``rec.spans``: the
trace summary then drops their device-side copies from busy time and
names idle gaps by them.

A checkout whose program has no tracer has nothing to read: ``install``
does nothing and every reading is None."""

from __future__ import annotations

from typing import Optional

_STATE = "program_spans"


def _profiling():
    """The program's profiling module, or None where it has no tracer."""
    from modular_rag_system_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "TRACER") else None


def install(run, rec) -> None:
    prof = _profiling()
    if prof is None or _STATE in run.state:
        return
    for name in prof.TIMELINE_SPANS:
        rec.spans[name]  # a key of the recorder's defaultdict, with no time
    tracer = prof.TRACER
    run.state[_STATE] = None

    def after_unit(rec, args, kwargs, out):
        run.state[_STATE] = (tracer.totals(), tracer.counters())

    rec.hook(run, "tick", on_call=after_unit)
    tracer.reset()
    tracer.enable()


def _window(run):
    """(totals, counters) after the window's last unit, or None; turns
    the tracer off."""
    prof = _profiling()
    if prof is None:
        return None
    prof.TRACER.disable()
    snap = run.state.get(_STATE)
    if snap is None or not getattr(run, "units", 0):
        return None
    return snap


def ms_per_unit(run, name: str) -> Optional[float]:
    """Milliseconds in span ``name`` per unit of the window (a call, a
    step); 0 when the span never ran in a traced window."""
    snap = _window(run)
    if snap is None:
        return None
    seconds, _ = snap[0].get(name, (0.0, 0))
    return seconds * 1e3 / run.units


def share(run, part: str, whole: str) -> Optional[float]:
    """Counter ``part`` over counter ``whole`` in the window, in percent."""
    snap = _window(run)
    if snap is None or not snap[1].get(whole):
        return None
    return 100.0 * snap[1].get(part, 0) / snap[1][whole]
