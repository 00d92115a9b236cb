"""The port's tracer (``utils/profiling.py`` ``TRACER``) on the CPU.

Off, a span is one flag test that hands back a shared no-op, and nothing
is recorded.  On, one ``ContrastiveTrainer.step`` and one
``RAGEngine.add_documents`` give their layer spans under one root, the
token counters equal to the masks' sums and sizes, a "gc" span for every
collection, and their layer spans on ``device_trace``'s timeline.
"""

import gc
import json
import sys
import threading

import pytest

from modular_rag_system_tpu_torch import RAGConfig, create_engine
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder, _next_pow2
from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer
from modular_rag_system_tpu_torch.types import Document
from modular_rag_system_tpu_torch.utils.profiling import (
    TIMELINE_SPANS,
    TRACER,
    device_trace,
)

QS = ["what is jax", "tpu hardware", "python dataclass", "sqlite storage", "http server"]
PS = ["jax is a numerical computing library", "tensor processing units accelerate matmuls",
      "dataclasses generate init and repr", "sqlite is an embedded relational database",
      "servers respond to get and post requests"]
DOCS = ["the store keeps every document in sqlite",
        "rows are appended to the device index in one call",
        "a content hash names each document",
        "the encoder pools its last layer into one unit vector",
        "short"]

TRAIN_ORDER = ["trainer.tokenize", "trainer.forward", "trainer.tokenize", "trainer.forward",
               "trainer.forward", "trainer.backward", "trainer.update", "trainer.readback"]
INGEST_ORDER = ["encoder.tokenize", "encoder.forward", "store.lookup", "store.rows",
                "store.write", "store.commit", "index.add"]


def _trainer():
    enc = MiniLMEncoder(dim=64, max_seq_len=32, batch_size=16, num_layers=2, num_heads=4,
                        mlp_dim=128, vocab_size=1000, dtype="float32", device="cpu")
    return ContrastiveTrainer(enc, learning_rate=1e-3)


@pytest.fixture
def tracer():
    before = list(gc.callbacks)
    TRACER.reset()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.reset()
    assert gc.callbacks == before


def _one_root(spans, name, order):
    """The root span ``name`` and its layer spans, which lie under it
    (parent and root both the root's id), in ``order`` and apart."""
    roots = [s for s in spans if s.name == name]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.root == root.id
    layer = sorted((s for s in spans if s.name in TIMELINE_SPANS), key=lambda s: s.start_ns)
    assert [s.name for s in layer] == order
    for s in layer:
        assert s.parent == root.id and s.root == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for a, b in zip(layer, layer[1:]):
        assert a.end_ns <= b.start_ns
    return root, layer


def test_off_records_nothing():
    assert not TRACER.on
    before = list(gc.callbacks)
    TRACER.reset()
    shared = {id(TRACER.span(n)) for n in TIMELINE_SPANS} | {id(TRACER.root("trainer.step"))}
    assert len(shared) == 1
    with TRACER.root("trainer.step"), TRACER.span("trainer.update"):
        TRACER.count("trainer.real_tokens", 5)
    _trainer().step(QS, PS)
    gc.collect()
    assert TRACER.spans() == [] and TRACER.totals() == {} and TRACER.counters() == {}
    assert TRACER.stats() == {"spans": {}, "counters": {}}
    assert gc.callbacks == before


def test_trainer_step(tracer):
    tr = _trainer()
    tr.step(QS, PS)
    _one_root(tracer.spans(), "trainer.step", TRAIN_ORDER)
    masks = [tr.encoder.tokenizer.encode_batch(t)[1] for t in (QS, PS)]
    counters = tracer.counters()
    assert counters["trainer.real_tokens"] == sum(int(m.sum()) for m in masks)
    assert counters["trainer.padded_tokens"] == sum(m.size for m in masks)
    totals = tracer.totals()
    assert totals["trainer.forward"][1] == 3 and totals["trainer.tokenize"][1] == 2
    stats = tracer.stats()
    assert stats["spans"]["trainer.step"]["count"] == 1
    assert stats["spans"]["trainer.forward"]["total_s"] == pytest.approx(
        totals["trainer.forward"][0])
    assert stats["counters"] == counters


def test_add_documents(tracer, tmp_path):
    eng = create_engine(RAGConfig.load(overrides={
        "store.storage_path": str(tmp_path / "store"), "embedding.lexical_dim": 0,
        "embedding.dtype": "float32"}), device="cpu")
    try:
        tracer.reset()
        eng.add_documents([Document(content=c, source="t") for c in DOCS])
        _one_root(tracer.spans(), "engine.add_documents", INGEST_ORDER)
        enc = eng.encoder
        assert isinstance(enc, MiniLMEncoder) and len(DOCS) <= enc.batch_size
        _, mask = enc._crop_seq(*enc.tokenizer.encode_batch(DOCS))
        counters = tracer.counters()
        assert counters["encoder.real_tokens"] == int(mask.sum())
        assert counters["encoder.padded_tokens"] == _next_pow2(len(DOCS)) * mask.shape[1]
        assert counters["encoder.padded_tokens"] > counters["encoder.real_tokens"]
    finally:
        eng.store.close()


def test_gc_spans(tracer):
    with TRACER.root("trainer.step"), TRACER.span("trainer.update"):
        gc.collect()
    gc.collect(0)
    spans = tracer.spans()
    parent = next(s for s in spans if s.name == "trainer.update")
    gcs = [s for s in spans if s.name == "gc"]
    forced = [s for s in gcs if s.parent == parent.id and s.gen == 2]
    assert len(forced) == 1 and forced[0].root == parent.root
    assert any(s.gen == 0 and s.parent is None and s.root is None for s in gcs)
    assert all(s.end_ns >= s.start_ns for s in gcs)
    assert tracer.counters()["gc.gen2"] == sum(s.gen == 2 for s in gcs)


def test_enable_disable_restore_gc_callbacks():
    before = list(gc.callbacks)
    TRACER.enable()
    TRACER.enable()
    assert gc.callbacks == before + [TRACER._gc_cb]
    TRACER.disable()
    TRACER.disable()
    assert gc.callbacks == before
    TRACER.reset()


def test_layer_spans_on_device_trace(tracer, tmp_path):
    tr = _trainer()
    with device_trace(str(tmp_path / "trace"), device="cpu"):
        tr.step(QS, PS)
    names = {ev.get("name") for ev in json.loads(
        (tmp_path / "trace" / "trace.json").read_text())["traceEvents"]}
    assert set(TRAIN_ORDER) <= names
    # roots and collections stay in memory
    assert "trainer.step" not in names and "gc" not in names


def test_threads_share_totals(tracer):
    """Many threads, each under its own roots: no total or counter is
    lost, and each span stays under its own thread's root."""
    n_threads, n_roots = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n_roots):
            with TRACER.root("engine.add_documents"):
                with TRACER.span("store.rows"):
                    TRACER.count("encoder.real_tokens", 3)
                with TRACER.span("store.write"):
                    pass

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    n = n_threads * n_roots
    totals = tracer.totals()
    assert totals["engine.add_documents"][1] == totals["store.rows"][1] == n
    assert tracer.counters()["encoder.real_tokens"] == 3 * n
    spans = tracer.spans()
    roots = {s.id: s for s in spans if s.name == "engine.add_documents"}
    for s in spans:
        if s.name.startswith("store."):
            r = roots[s.root]
            assert s.parent == r.id and s.thread == r.thread
    assert all(s.end_ns >= s.start_ns for s in spans)
