"""The readers of the program's own spans and counters
(``portbench/program_spans.py``): every layer span name the program can
put on the profiler's timeline is registered with the recorder, a traced
tiny CPU run of each cell reports every such metric with its unit, and
the store's four spans fit inside the outside hook's upsert time."""

from __future__ import annotations

import gc

import pytest
import torch

from portbench import common
from portbench.hooks import Recorder
from portbench.tests.pb_tiny import CELLS, run_tiny

from modular_rag_system_tpu_torch.utils.profiling import TIMELINE_SPANS, TRACER

PROGRAM = {
    "hybrid-finetune": {"finetune.tokenize_ms", "finetune.forward_ms", "finetune.backward_ms",
                        "finetune.real_token_share", "finetune.gc_ms"},
    "minilm-ingest-1m": {"ingest.store_lookup_ms", "ingest.store_rows_ms",
                         "ingest.store_write_ms", "ingest.store_commit_ms",
                         "ingest.real_token_share", "ingest.gc_ms"},
}
STORE = ["ingest.store_lookup_ms", "ingest.store_rows_ms", "ingest.store_write_ms",
         "ingest.store_commit_ms"]


class _Run:
    def __init__(self):
        self.state = {}
        self.ticks = 0

    def tick(self):
        self.ticks += 1


@pytest.mark.parametrize("cell", CELLS)
def test_readers_register_every_timeline_span(cell):
    """Each reader of the cell installs the tracer once and registers the
    whole timeline set, without time in it."""
    bench = common.benchmark()
    names = [m["name"] for m in common.per_layer_for(bench, cell) if m["name"] in PROGRAM[cell]]
    assert set(names) == PROGRAM[cell]
    before = list(gc.callbacks)
    rec, run = Recorder(torch.device("cpu")), _Run()
    try:
        for name in names:
            common.layer(name).install(run, rec)
            assert TIMELINE_SPANS <= set(rec.spans)
        assert TRACER.on and len(gc.callbacks) == len(before) + 1
        assert all(rec.span_total(n) is None for n in TIMELINE_SPANS)
        # one unit of a window, then what follows the window
        rec.active = True
        for n in TIMELINE_SPANS:
            with TRACER.span(n):
                pass
        for layer in ("trainer", "encoder"):
            TRACER.count(f"{layer}.real_tokens", 1)
            TRACER.count(f"{layer}.padded_tokens", 4)
        run.tick()
        rec.active = False
        TRACER.count("trainer.real_tokens", 3)
        TRACER.count("encoder.real_tokens", 3)
        assert run.ticks == 1
        run.units = 2
        got = {n: common.layer(n).read(run, rec, None) for n in names}
        assert all(v is not None and v >= 0 for v in got.values()), got
        assert [v for n, v in got.items() if n.endswith("share")] == [25.0]
        assert not TRACER.on and gc.callbacks == before
    finally:
        rec.restore()
        TRACER.disable()
        TRACER.reset()


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_program_metrics(capsys, cell):
    rc, out = run_tiny(capsys, cell, trace=1)
    assert rc == 0 and out["correct"] is True, out and out["checks"]
    units = {m["name"]: m["unit"] for m in common.benchmark()["per_layer"]}
    for name in PROGRAM[cell]:
        assert out["metrics"][name]["unit"] == units[name], name
        assert out["metrics"][name]["value"] >= 0, name
    share = out["metrics"][cell.split("-")[0].replace("minilm", "ingest").replace(
        "hybrid", "finetune") + ".real_token_share"]["value"]
    assert 0 < share < 100
    assert not TRACER.on
    if cell == "minilm-ingest-1m":
        store = [out["metrics"][n]["value"] for n in STORE]
        assert sum(store) <= out["metrics"]["ingest.store_upsert_ms"]["value"] * 1.1
