#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with an NVIDIA GPU.  The run
sets up the cell (builds the engine, fills it, warms the cell's own
shapes), checks that the warm-up took the cell's route, measures for
``--seconds``, frees the program's state, holds what the window produced
against the plain reference, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and with ``--trace 1`` the ``breakdown`` of the profiler's trace), and
``checks`` last, each number compared beside its limit.  With ``--trace
0`` the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.

It exits non-zero and prints no result when there is no card, fewer
cards than the cell asks for, when a module of the JAX stack or the JAX
package is loaded once the window has closed, or when the run fails.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402
from portbench.common import log  # noqa: E402


# a traced run profiles the first TRACE_SECONDS of its window: the
# profiler's records of a longer window take minutes to read back
TRACE_SECONDS = 5.0


class Run:
    """What one run knows: its arguments, the cell, its configuration and
    traffic parameters, the device, a scratch directory, and whatever the
    traffic kind's set-up builds (``engine``, ``trainer``).

    A traffic kind's window calls ``tick`` between its calls into the
    program, so that a traced run closes its profile after
    TRACE_SECONDS."""

    def __init__(self, args, cell: Dict[str, Any], config: Dict[str, Any],
                 params: Dict[str, Any], device, work: Path) -> None:
        self.args, self.seed, self.seconds = args, args.seed, args.seconds
        self.name = args.workload
        self.cell, self.config, self.params = cell, config, params
        self.device, self.work = device, work
        self.spec = None
        self.state: Dict[str, Any] = {}
        self._prof = None
        self._prof_t0 = 0.0
        self.trace_s = 0.0
        self.profiling = False

    def start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._prof_t0 = time.perf_counter()
        self.profiling = True

    def tick(self) -> None:
        if self._prof is not None and time.perf_counter() - self._prof_t0 >= TRACE_SECONDS:
            self.stop_trace()

    def stop_trace(self) -> None:
        if self._prof is None or self.trace_s:
            return
        self.sync()
        self.profiling = False
        self._prof.__exit__(None, None, None)
        self.trace_s = time.perf_counter() - self._prof_t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _merge(base: Dict[str, Any], extra: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _number(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def main(argv: Optional[List[str]] = None, device=None,
         overrides: Optional[Dict[str, Any]] = None) -> int:
    """``device`` and ``overrides`` serve the tests, which run a cell on
    the CPU at a small size: ``overrides`` merges into the cell
    (``cell``), its configuration (``config``) and its traffic
    (``params``)."""
    args = parse(argv)
    common.set_cache_env()
    overrides = overrides or {}
    bench = common.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = _merge(common.cell(args.workload), overrides.get("cell"))
    config = _merge(common.config(cell["config"]), overrides.get("config"))
    params = _merge(_merge(common.mix(cell["traffic"]), cell.get("params")),
                    overrides.get("params"))

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            log(f"the cell needs {entry['chips']} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
            return 2
        device = torch.device("cuda:0")
    device = torch.device(device)
    kind = common.traffic(params["kind"])
    e2e = common.end_to_end_for(bench, args.workload)
    layer_defs = common.per_layer_for(bench, args.workload) if args.trace else []

    tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = Path(tempfile.mkdtemp(prefix="portbench-", dir=tmp_root))
    run = Run(args, cell, config, params, device, work)
    out: Dict[str, Any] = {}
    try:
        if device.type == "cuda":
            run.spec = common.spec_for(torch.cuda.get_device_name(device))
            run.power = common.power_limit()
            log(f"card: {run.power}")
        kind.setup(run)
        rec = None
        layers = []
        if args.trace:
            from portbench.hooks import Recorder

            rec = Recorder(device)
            for m in layer_defs:
                mod = common.layer(m["name"])
                mod.install(run, rec)
                layers.append((m, mod))
        setup_s = time.perf_counter() - T0
        log(f"set-up {setup_s:.3f} s")
        if args.trace:
            run.start_trace()
            rec.active = True
        res = kind.window(run)
        run.window_s = res["window_s"]
        summary = None
        if args.trace:
            rec.active = False
            run.stop_trace()
            from portbench.hooks import summarize

            summary = summarize(run._prof, run.trace_s, set(rec.spans))
            run._prof = None
        mem = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        metrics: Dict[str, Dict[str, Any]] = {}
        if args.trace:
            for m, mod in layers:
                v = mod.read(run, rec, summary)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            rec.restore()
        else:
            values = dict(res["metrics"], setup_s=setup_s)
            for m in e2e:
                metrics[m["name"]] = {"value": _number(values[m["name"]]), "unit": m["unit"]}
        kind.release(run)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = kind.check(run)
        log("readings: " + json.dumps(checks))
        limits = cell["limits"]
        correct = all(checks[k] <= limits[k] for k in limits)
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": int(mem)}
        if summary is not None:
            dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out = {"correct": bool(correct), "attempted": int(res["attempted"]),
               "failed": int(res["failed"]), "metrics": metrics, "device": dev}
        if summary is not None:
            out["breakdown"] = summary["breakdown"]
        out["checks"] = {k: {"value": _number(checks[k]), "limit": limits[k]} for k in limits}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = common.forbidden_loaded()
    if found:
        log(f"modules of the JAX stack or the JAX package are loaded: {found}")
        return 3
    for k, c in out["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
