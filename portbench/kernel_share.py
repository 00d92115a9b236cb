"""What the readers of a kernel's share of its roofline need: the
program's counters over the profiled part of the window, and a kernel's
device time in the profile.

The profile covers the window's first ``run.py`` ``TRACE_SECONDS`` (or all of
it): the counters are taken after each unit of the window up to and
including the one whose ``run.tick`` closed the profile.  A checkout
whose program has no tracer has nothing to read: every reading is None."""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

from portbench import program_spans

_STATE = "kernel_share"


def install(run, rec) -> None:
    program_spans.install(run, rec)
    prof = program_spans._profiling()
    if prof is None or _STATE in run.state:
        return
    run.state[_STATE] = None

    def after_unit(rec, args, kwargs, out):
        if run.state.get(_STATE + ".closed"):
            return
        run.state[_STATE] = prof.TRACER.counters()
        run.state[_STATE + ".closed"] = bool(run.trace_s)

    rec.hook(run, "tick", on_call=after_unit)


def counters(run) -> Optional[Dict[str, int]]:
    """The program's counters over the profiled units, or None."""
    return run.state.get(_STATE)


def device_seconds(trace, match: Callable[[str], bool]) -> Optional[float]:
    """Device seconds of the profile's kernels whose name ``match``
    accepts, or None when none ran."""
    if not trace:
        return None
    t = sum(s for name, (s, _) in trace["kernels"].items() if match(name))
    return t if t > 0 else None


_MEA = re.compile(r"mea_(?:bf16|f32)_kernel<([^>]*)>")


def mea_mode(name: str) -> Optional[str]:
    """"window" or "full" for a ``mea_attention`` kernel's profiled name
    (the last template argument is its window flag), else None."""
    m = _MEA.search(name)
    if m is None:
        return None
    return "window" if m.group(1).replace(" ", "").endswith("true") else "full"
