"""Whole runs of each cell on the CPU at a small size: the last line's
schema, the route check, the control reading above the cell's limits,
and the timed path broken underneath a run turning ``correct`` false.
One test drives a short run on the card and skips without one."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import common, engines
from portbench.common import ROOT
from portbench.tests.pb_tiny import CELLS, TINY, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _assert_schema(out, cell, trace):
    keys = list(out)
    assert keys[-1] == "checks" and set(KEYS) <= set(keys)
    assert ("breakdown" in out) == bool(trace)
    bench = common.benchmark()
    want = (common.per_layer_for(bench, cell) if trace else common.end_to_end_for(bench, cell))
    units = {m["name"]: m["unit"] for m in want}
    assert set(out["metrics"]) <= set(units)
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if not trace:
        assert set(out["metrics"]) == set(units)
    for k, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
        assert c["limit"] == common.cell(cell)["limits"][k]
    assert out["device"]["count"] == 1 and "memory_peak_bytes" in out["device"]
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        b = out["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_and_schema(capsys, cell):
    rc, out = run_tiny(capsys, cell, trace=1 if cell == "minilm-ingest-1m" else 0)
    assert rc == 0
    _assert_schema(out, cell, cell == "minilm-ingest-1m")
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_no_card_no_result():
    """Without a card (and without the tests' CPU device) a run exits
    non-zero and prints nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hybrid-finetune",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_route_check_refuses_another_route():
    eng = SimpleNamespace(index=SimpleNamespace(effective_tier=lambda: "int8"))
    # a retrieval cell's route: the int8 two-pass search and no ivf kernel
    route = {"tier": "int8", "launch": ["binmax_int8"],
             "no_launch": ["fine_scores", "fine_topk", "fine_binmax"]}
    engines.check_route(route, eng, {"binmax_int8": 2, "fine_scores": 0})
    with pytest.raises(RuntimeError):
        engines.check_route(route, eng, {"binmax_int8": 0})
    with pytest.raises(RuntimeError):
        engines.check_route(route, eng, {"binmax_int8": 2, "fine_scores": 1})
    ivf = SimpleNamespace(index=SimpleNamespace(effective_tier=lambda: "ivf"))
    with pytest.raises(RuntimeError):
        engines.check_route(route, ivf, {"binmax_int8": 2})


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_a_limit(cell):
    """The control (the reference put in the program's place in fp8, the
    precision below the configurations' bf16) reads above at least one of
    the cell's limits."""
    from portbench import calibrate

    over = json.dumps({k: v for k, v in TINY[cell].items() if k != "cell"})
    from io import StringIO
    from contextlib import redirect_stdout

    buf = StringIO()
    with redirect_stdout(buf):
        assert calibrate.main(["--workload", cell, "--seeds", "21", "--precision", "fp8",
                               "--device", "cpu", "--seconds", "2", "--overrides", over]) == 0
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    limits = common.cell(cell)["limits"]
    assert any(got[k] > v for k, v in limits.items()), (got, limits)


# ---------------------------------------------------------------------------
# faults planted under a run: each must turn ``correct`` false
def _altered_rows(monkeypatch):
    """An answer altered where it is produced: the index stores each new
    embedding with its dense half's sign flipped on one coordinate."""
    from modular_rag_system_tpu_torch.index import DeviceIndex

    orig = DeviceIndex.add

    def add(self, mat):
        x = torch.as_tensor(mat).clone()
        x[:, 0] = -x[:, 0] + 0.1
        return orig(self, x)

    monkeypatch.setattr(DeviceIndex, "add", add)


def _unchanged_store(monkeypatch):
    """A step that returns its state unchanged: ``add_documents`` embeds the
    documents, hands back their ids and stores nothing."""
    from modular_rag_system_tpu_torch.engine import RAGEngine

    orig = RAGEngine.add_documents

    def add_documents(self, docs):
        docs = list(docs)
        if docs and docs[0].source == "notes":  # the cell's documents, not the filler
            self.encoder.encode_device([d.content for d in docs])
            return [d.id for d in docs]
        return orig(self, docs)

    monkeypatch.setattr(RAGEngine, "add_documents", add_documents)


def _no_update(monkeypatch):
    """A step that returns its state unchanged: the update is skipped."""
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    monkeypatch.setattr(ContrastiveTrainer, "_update", lambda self, grads: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    orig = ContrastiveTrainer.step

    def step(self, queries, positives):
        n = len(queries) // 2
        return orig(self, list(queries)[:n], list(positives)[:n])

    monkeypatch.setattr(ContrastiveTrainer, "step", step)


def _reversed_gradient(monkeypatch):
    """A gradient of the right size pointing elsewhere: the update takes
    the negated gradient."""
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    orig = ContrastiveTrainer._update
    monkeypatch.setattr(ContrastiveTrainer, "_update",
                        lambda self, grads: orig(self, {k: -g for k, g in grads.items()}))


FAULTS = [("minilm-ingest-1m", _altered_rows), ("minilm-ingest-1m", _unchanged_store),
          ("hybrid-finetune", _no_update), ("hybrid-finetune", _half_batch),
          ("hybrid-finetune", _reversed_gradient)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_turns_correct_false(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, out = run_tiny(capsys, cell)
    assert rc == 0 and out["correct"] is False, out and out["checks"]


# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hybrid-finetune",
                          "--seed", "5", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
