"""The port's engine lifecycle and store methods against the JAX package's,
on the CPU, and the engine under concurrent queries and compactions.

Both engines get the bundled hybrid encoder at float32, ``tier="auto"``
(below 8192 rows of capacity: the single-pass ``fused_topk_int8`` route),
no recency weight and no threshold, the same knowledge texts with
timestamps drawn from a numpy seed, and near-duplicate rows with seeded
embeddings.  After ``cleanup_old_documents``, ``compact`` and
``reembed_all`` the returned doc ids must be equal (tie order included)
and similarities within 1e-5; ``get_enhanced_context`` and
``export_data`` must be equal field for field once the time-valued
fields are dropped.
"""

import gzip
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

from modular_rag_system_tpu.config import RAGConfig as JaxConfig
from modular_rag_system_tpu.engine import RAGEngine as JaxEngine
from modular_rag_system_tpu.store import DocumentStore as JaxStore
from modular_rag_system_tpu.types import Document as JaxDocument
from modular_rag_system_tpu_torch import RAGConfig, create_engine
from modular_rag_system_tpu_torch.store import DocumentStore
from modular_rag_system_tpu_torch.types import Document
from torch_parity import assert_same_fields

_TRAIN = Path(__file__).resolve().parents[1] / "modular_rag_system_tpu" / "assets" / "train"
KNOWLEDGE = json.loads((_TRAIN / "knowledge.json").read_text())["sentences"][:120]
QUERIES = [it["query"] for it in json.loads((_TRAIN / "qa_pairs.json").read_text())["items"][:6]]


def _overrides(path):
    return {"index.tier": "auto", "embedding.dtype": "float32",
            "retrieval.time_weight": 0.0, "retrieval.similarity_threshold": 0.0,
            "store.storage_path": str(path)}


def _assert_same(jres, pres):
    for j, p in zip(jres, pres, strict=True):
        assert [d.id for d in j.documents] == [d.id for d in p.documents]
        np.testing.assert_allclose(j.similarities, p.similarities, rtol=0, atol=1e-5)


def _both_queries(jeng, peng):
    _assert_same(jeng.query_batch(QUERIES, max_results=5),
                 peng.query_batch(QUERIES, max_results=5))
    _assert_same([jeng.query(QUERIES[1], max_results=8)],
                 [peng.query(QUERIES[1], max_results=8)])


def _corpus(jeng, rng, now):
    """(text docs, near-duplicate pre-embedded docs) as (content, source,
    timestamp, embedding) tuples; ages up to 60 days."""
    ages = rng.uniform(0.0, 60.0, len(KNOWLEDGE) + 60) * 86400.0
    texts = [(t, "knowledge", now - a, None) for t, a in zip(KNOWLEDGE, ages)]
    jeng.add_documents([JaxDocument(content=c, source=s, timestamp=ts)
                        for c, s, ts, _ in texts])
    emb = np.asarray(jeng.index.E[: len(KNOWLEDGE)], np.float32)
    fill = emb[rng.integers(0, len(KNOWLEDGE), 60)]
    fill = fill + 0.3 * rng.standard_normal(fill.shape).astype(np.float32) / np.sqrt(768)
    fill /= np.linalg.norm(fill, axis=1, keepdims=True)
    near = [(f"near duplicate {i}", "filler", now - a, e)
            for i, (e, a) in enumerate(zip(fill, ages[len(KNOWLEDGE):]))]
    jeng.add_documents([JaxDocument(content=c, source=s, timestamp=ts, embedding=e)
                        for c, s, ts, e in near])
    return texts, near


def test_lifecycle_parity_with_jax(tmp_path):
    jeng = JaxEngine(JaxConfig.load(overrides=_overrides(tmp_path / "jax")))
    peng = create_engine(RAGConfig.load(overrides=_overrides(tmp_path / "port")),
                         device="cpu")
    texts, near = _corpus(jeng, np.random.default_rng(11), time.time())
    peng.add_documents([Document(content=c, source=s, timestamp=ts)
                        for c, s, ts, _ in texts])
    peng.add_documents([Document(content=c, source=s, timestamp=ts, embedding=e)
                        for c, s, ts, e in near])
    assert peng.index.count == jeng.index.count == len(texts) + len(near)
    assert peng.index.capacity == 4096
    _both_queries(jeng, peng)
    assert_same_fields(jeng.get_enhanced_context(QUERIES[0]),
                       peng.get_enhanced_context(QUERIES[0]))

    # retention: documents older than 30 days leave the results
    old = {Document(content=c, source=s).id for c, s, ts, _ in texts + near
           if ts < time.time() - 30 * 86400.0}
    assert 0 < len(old) < len(texts) + len(near)
    assert jeng.cleanup_old_documents(30.0) == peng.cleanup_old_documents(30.0) == len(old)
    _both_queries(jeng, peng)
    # (both engines, so the store's access counts stay equal)
    deep = peng.query_batch(QUERIES, max_results=20)
    _assert_same(jeng.query_batch(QUERIES, max_results=20), deep)
    for r in deep:
        assert not old & {d.id for d in r.documents}

    # compaction: rows reclaimed, surviving ids and their order unchanged
    live = [d.id for _r, d in peng.store.iter_all()]
    assert jeng.compact() == peng.compact() == len(old)
    assert [d.id for _r, d in peng.store.iter_all()] == live
    assert [r for r, _d in peng.store.iter_all()] == list(range(len(live)))
    assert peng.index.count == jeng.index.count == len(live)
    assert peng.index.capacity == 4096
    _both_queries(jeng, peng)

    # re-embedding: every live row from its text, at the same row numbers
    assert jeng.reembed_all() == peng.reembed_all() == len(live)
    _both_queries(jeng, peng)
    assert_same_fields(jeng.get_enhanced_context(QUERIES[2]),
                       peng.get_enhanced_context(QUERIES[2]))

    out_j, out_p = (jeng.export_data(str(tmp_path / "j.json.gz")),
                    peng.export_data(str(tmp_path / "p.json.gz")))
    with gzip.open(out_j, "rt") as f:
        exp_j = json.load(f)
    with gzip.open(out_p, "rt") as f:
        exp_p = json.load(f)
    for exp, root in ((exp_j, tmp_path / "jax"), (exp_p, tmp_path / "port")):
        assert exp["stats"].pop("db_path") == str(root / "documents.db")
    assert_same_fields(exp_j, exp_p)
    assert len(exp_p["recent_documents"]) == min(100, len(live))
    # the rebuilt index and the store survive a restart
    before = peng.query_batch(QUERIES, max_results=5)
    peng.shutdown()
    again = create_engine(RAGConfig.load(overrides=_overrides(tmp_path / "port")),
                          device="cpu")
    _assert_same(before, again.query_batch(QUERIES, max_results=5))


def test_enhanced_context_of_an_empty_engine(tmp_path):
    cfg = {"embedding.model": "fake", "store.storage_path": str(tmp_path / "p")}
    peng = create_engine(RAGConfig.load(overrides=cfg), device="cpu")
    jeng = JaxEngine(JaxConfig.load(overrides={**cfg, "store.storage_path": str(tmp_path / "j")}))
    assert peng.get_enhanced_context("anything") == jeng.get_enhanced_context("anything")
    assert peng.cleanup_old_documents() == jeng.cleanup_old_documents() == 0
    assert peng.compact() == jeng.compact() == 0
    assert peng.reembed_all() == jeng.reembed_all() == 0


def test_store_methods_parity_with_jax(tmp_path):
    rng = np.random.default_rng(4)
    ts = time.time() - rng.uniform(0, 10, 50) * 86400.0
    port, ref = DocumentStore(str(tmp_path / "p")), JaxStore(str(tmp_path / "j"))
    port.upsert_batch([Document(content=f"doc {i}", timestamp=t) for i, t in enumerate(ts)])
    ref.upsert_batch([JaxDocument(content=f"doc {i}", timestamp=t) for i, t in enumerate(ts)])
    some = Document(content="doc 7").id
    assert port.get_by_id(some).to_dict() == ref.get_by_id(some).to_dict()
    assert port.get_by_id("absent") is None and ref.get_by_id("absent") is None
    cutoff = time.time() - 5 * 86400.0
    assert port.delete_older_than(cutoff) == ref.delete_older_than(cutoff) > 0
    assert (port.get_by_id(some) is None) == (ts[7] < cutoff)
    live_p, live_j = port.compact(), ref.compact()
    assert live_p == live_j == [i for i in range(50) if ts[i] >= cutoff]
    assert port.max_row() == ref.max_row() == len(live_p) - 1
    assert port.stats()["total_documents"] == len(live_p)
    with gzip.open(port.export_gzip_json(str(tmp_path / "p.gz"), recent=7), "rt") as f:
        got = json.load(f)
    with gzip.open(ref.export_gzip_json(str(tmp_path / "j.gz"), recent=7), "rt") as f:
        want = json.load(f)
    got["stats"].pop("db_path"), want["stats"].pop("db_path")
    assert_same_fields(want, got)
    assert [d["timestamp"] for d in got["recent_documents"]] == \
        [d["timestamp"] for d in want["recent_documents"]]


def test_queries_during_compaction(tmp_path):
    # query_batch from several threads while another thread deletes and
    # compacts (which renumbers the store's rows and swaps the index):
    # no exception, every returned document exists, and every returned
    # similarity is the cosine of the query with THAT document (a row
    # resolved against the other numbering would name another document)
    cfg = RAGConfig.load(overrides={
        "embedding.model": "fake", "index.tier": "int8",
        "retrieval.time_weight": 0.0, "retrieval.similarity_threshold": 0.0,
        "store.storage_path": str(tmp_path)})
    eng = create_engine(cfg, device="cpu")
    rng = np.random.default_rng(2)
    now = time.time()
    ages = rng.uniform(0.0, 60.0, 600) * 86400.0
    docs = [Document(content=f"note {i} about topic {i % 37} and item {i % 11}",
                     timestamp=now - a) for i, a in enumerate(ages)]
    eng.add_documents(docs)
    ids = {d.id for d in docs}
    queries = [f"topic {i} and item {i % 11}" for i in range(37)]
    errors, checked = [], [0]
    done, answered = threading.Event(), threading.Event()

    def querier(seed):
        r = np.random.default_rng(seed)
        try:
            while not done.is_set():
                qs = [queries[i] for i in r.integers(0, len(queries), 4)]
                for q, res in zip(qs, eng.query_batch(qs, max_results=5)):
                    qv = eng.encoder.encode([q])[0]
                    for d, s in zip(res.documents, res.similarities):
                        assert d.id in ids, d.id
                        want = float(np.clip(qv @ eng.encoder.encode([d.content])[0], 0, 1))
                        assert abs(s - want) < 1e-4, (q, d.content, s, want)
                        checked[0] += 1
                answered.set()
        except Exception as exc:  # noqa: BLE001 - reported by the test
            errors.append(exc)

    def compactor():
        try:
            answered.wait(timeout=60)  # compactions start among queries in flight
            for days in (55, 50, 45, 40, 35, 30):
                eng.cleanup_old_documents(days)
                eng.compact()
        except Exception as exc:  # noqa: BLE001 - reported by the test
            errors.append(exc)
        finally:
            done.set()

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=querier, args=(s,)) for s in range(6)]
        threads.append(threading.Thread(target=compactor))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old_interval)
    assert not errors, errors
    assert checked[0] > 0
    assert eng.index.count == eng.store.count() == int((ages < 30 * 86400.0).sum())
    assert eng._swap_gen == 12 and eng._stable.is_set()
