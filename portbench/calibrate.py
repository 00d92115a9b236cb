#!/usr/bin/env python3
"""Readings for the limits of a cell's check: the control (the plain
reference put in the program's place at a lower precision) and the
witness (the reference at the configurations' own bf16 operand rounding),
each judged by the f32 reference on the inputs a run of the cell judges,
at the cell's own size.  The benchmark's runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --precision fp8 [--precision bf16]

Prints one JSON line a (seed, precision): the cell's compared numbers.
Each traffic kind's ``calibrate`` picks the judged inputs by the rule
its window uses.  Needs a CUDA device (``--device cpu`` for a small
rehearsal)."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402
from portbench.run import Run, _merge  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=common.benchmark()["run_seconds"])
    ap.add_argument("--precision", action="append", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}", help="JSON, as run.main's")
    args = ap.parse_args(argv)
    import torch

    over = json.loads(args.overrides)
    cell = _merge(common.cell(args.workload), over.get("cell"))
    config = _merge(common.config(cell["config"]), over.get("config"))
    params = _merge(_merge(common.mix(cell["traffic"]), cell.get("params")), over.get("params"))
    for seed in (int(s) for s in args.seeds.split(",")):
        for precision in args.precision:
            ns = SimpleNamespace(seed=seed, seconds=args.seconds, workload=args.workload)
            with tempfile.TemporaryDirectory() as work:
                run = Run(ns, cell, config, params, torch.device(args.device), Path(work))
                out = common.traffic(params["kind"]).calibrate(run, precision)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "precision": precision, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
