"""Running a cell of the benchmark on the CPU at a small size: the whole
run (set-up, window, release, check, the last line) with the program's
plain CPU paths; the route check, which reads the CUDA kernels' launch
counts, is left out."""

from __future__ import annotations

import json
import os

from portbench.common import benchmark

os.environ.setdefault("JAX_PLATFORMS", "cpu")

TINY = {
    "minilm-ingest-1m": {"config": {"corpus_rows": 16384}, "cell": {"route": None},
                         "params": {"batch": 16, "warm_calls": 1, "max_rows_per_s": 2000,
                                    "judge_max": 64}},
    "hybrid-finetune": {"params": {"batch": 32, "pool": 2}},
}


# the cells BENCHMARK.json holds
CELLS = sorted(set(TINY) & {w["name"] for w in benchmark()["workloads"]})


def run_tiny(capsys, cell: str, seed: int = 11, seconds: float = 1.0, trace: int = 0,
             overrides=None):
    """(exit code, the parsed last line or None) of one CPU run."""
    from portbench import run
    from portbench.run import _merge

    over = _merge(TINY[cell], overrides or {})
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", overrides=over)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
