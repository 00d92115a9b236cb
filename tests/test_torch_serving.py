"""The port's HTTP query server and query batcher against the JAX
package's, on the CPU.

Both systems use the fake encoder, ``index.tier="auto"`` (the
single-pass ``fused_topk_int8`` route below 8192 rows of capacity), no
recency weight and the query batcher on; the same requests go to both
servers, and the JSON bodies must be equal once the time-valued fields
are dropped, with doc ids equal (tie order included) and similarities
within 1e-5.  Concurrent non-enhanced queries through the batcher must
return the ids of ``engine.query_batch`` on the same questions.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import modular_rag_system_tpu as jpkg
import modular_rag_system_tpu_torch as ppkg
from modular_rag_system_tpu.batching import QueryBatcher as JBatcher
from modular_rag_system_tpu.facade import EnhancedRAGSystem as JSystem
from modular_rag_system_tpu.orchestration import processor as jprocessor
from modular_rag_system_tpu.serving import RAGHTTPServer as JServer
from modular_rag_system_tpu_torch.batching import QueryBatcher as PBatcher
from modular_rag_system_tpu_torch.facade import EnhancedRAGSystem as PSystem
from modular_rag_system_tpu_torch.orchestration import processor as pprocessor
from modular_rag_system_tpu_torch.serving import RAGHTTPServer as PServer
from torch_parity import assert_same_fields

_TRAIN = Path(__file__).resolve().parents[1] / "modular_rag_system_tpu" / "assets" / "train"
KNOWLEDGE = json.loads((_TRAIN / "knowledge.json").read_text())["sentences"][:150]
QUESTIONS = [it["query"] for it in
             json.loads((_TRAIN / "qa_pairs.json").read_text())["items"][:48]]


def _cfg(pkg, root):
    return pkg.RAGConfig.load(overrides={
        "embedding.model": "fake", "embedding.dim": 384, "index.tier": "auto",
        "store.storage_path": str(root), "serving.file_server_port": 0,
        "retrieval.similarity_threshold": 0.0, "retrieval.time_weight": 0.0,
        "serving.query_batch_window_ms": 20.0})


def _request(base, path, payload=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def servers(tmp_path):
    jsys = JSystem(_cfg(jpkg, tmp_path / "jax"), enable_llm=False)
    psys = PSystem(_cfg(ppkg, tmp_path / "port"), enable_llm=False, device="cpu")
    for s, pkg in ((jsys, jpkg), (psys, ppkg)):
        s.engine.add_documents([pkg.Document(content=t, source="knowledge",
                                             timestamp=1.7e9 + i)
                                for i, t in enumerate(KNOWLEDGE)])
    srvs = [JServer(jsys, port=0), PServer(psys, port=0)]
    bases = [f"http://127.0.0.1:{srv.start()}" for srv in srvs]
    yield (jsys, psys), srvs, bases
    for srv in srvs:
        srv.stop()
    jsys.shutdown()
    psys.shutdown()


def test_http_api_parity(servers, tmp_path, monkeypatch):
    # one response-cache bucket (5-minute buckets of the wall clock) for
    # the whole test in both processors: a bucket boundary between the two
    # servers' calls of one enhanced query would serve one of them fresh
    # and the other from its cache
    now = time.time()
    for proc in (jprocessor, pprocessor):
        monkeypatch.setattr(proc, "time",
                            SimpleNamespace(time=lambda: now, perf_counter=time.perf_counter))
    (jsys, psys), srvs, bases = servers
    assert all(srv.batcher is not None for srv in srvs)
    calls = [
        ("/health", None), ("/query", {"query": QUESTIONS[0], "enhanced": False}),
        ("/query", {"query": QUESTIONS[1], "enhanced": False, "max_results": 8}),
        ("/query", {"query": QUESTIONS[2], "enhanced": False, "similarity_threshold": 0.05}),
        ("/query", {"query": QUESTIONS[3]}),  # enhanced (the default)
        ("/query", {"query": QUESTIONS[3], "current_app": "editor"}),
        ("/add", {"content": "Added through the HTTP API: tides follow the moon.",
                  "source": "api"}),
        ("/add", {"content": "\n\n".join(KNOWLEDGE[:40]), "content_type": "document"}),
        ("/query", {"query": "what do tides follow?", "enhanced": False}),
        ("/feedback", {"query": QUESTIONS[0], "type": "positive"}),
        ("/files", None), ("/stats", None),
        # errors
        ("/query", {}), ("/add", {"source": "x"}), ("/feedback", {"query": "q"}),
        ("/feedback", {"query": "q", "type": "bogus"}), ("/nope", {}), ("/nope", None),
        ("/query", "not json{"),
    ]
    for path, payload in calls:
        got = []
        for base in bases:
            if isinstance(payload, str):
                got.append(_request(base, path, raw=payload.encode()))
            else:
                got.append(_request(base, path, payload))
        (jcode, jbody), (pcode, pbody) = got
        assert jcode == pcode, (path, payload, jbody, pbody)
        if path == "/stats":
            for body, root in ((jbody, "jax"), (pbody, "port")):
                assert body["engine"]["store"].pop("db_path") == \
                    str(tmp_path / root / "documents.db")
            assert pbody["engine"]["index"].pop("device") == "cpu"
            assert pbody["query_batcher"]["queries"] == 4
        assert_same_fields(jbody, pbody)
        if path == "/query" and isinstance(payload, dict) and payload.get("enhanced") is False:
            assert pbody["results"] and all(r["id"] for r in pbody["results"])
    # one row for the short /add, a few chunks for the long one
    assert psys.engine.index.count == jsys.engine.index.count > len(KNOWLEDGE) + 2


def test_http_batched_queries_match_query_batch(servers):
    (jsys, psys), srvs, bases = servers
    base, srv = bases[1], srvs[1]
    k, thr = 6, 0.02
    got, errors = {}, []

    def client(ci):
        try:
            for i in range(ci, len(QUESTIONS), 16):
                code, body = _request(base, "/query", {
                    "query": QUESTIONS[i], "enhanced": False, "max_results": k,
                    "similarity_threshold": thr})
                assert code == 200, body
                got[i] = body["results"]
        except Exception as exc:  # noqa: BLE001 - reported by the test
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    want = psys.engine.query_batch(QUESTIONS, max_results=k, similarity_threshold=thr)
    ref = jsys.engine.query_batch(QUESTIONS, max_results=k, similarity_threshold=thr)
    for i, (w, r) in enumerate(zip(want, ref)):
        assert [x["id"] for x in got[i]] == [d.id for d in w.documents] == \
            [d.id for d in r.documents]
        np.testing.assert_allclose([x["similarity"] for x in got[i]], r.similarities,
                                   rtol=0, atol=1e-5)
    stats = srv.batcher.stats
    assert stats["queries"] == len(QUESTIONS)
    assert stats["flushes"] < len(QUESTIONS) and stats["max_flush"] > 1


def test_http_concurrent_queries_and_adds(servers):
    (_jsys, psys), _srvs, bases = servers
    base, errors = bases[1], []
    n0 = psys.engine.index.count

    def querier(i):
        try:
            for j in range(5):
                code, out = _request(base, "/query", {"query": f"{QUESTIONS[i]} {j}",
                                                      "enhanced": False})
                assert code == 200 and "results" in out
        except Exception as exc:  # noqa: BLE001 - reported by the test
            errors.append(exc)

    def adder(i):
        try:
            for j in range(5):
                code, _ = _request(base, "/add", {"content": f"concurrent doc {i}-{j}"})
                assert code == 200
        except Exception as exc:  # noqa: BLE001 - reported by the test
            errors.append(exc)

    threads = [threading.Thread(target=querier, args=(i,)) for i in range(4)]
    threads += [threading.Thread(target=adder, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert psys.engine.index.count == psys.engine.store.count() == n0 + 15


def test_server_restart_recreates_batcher(servers):
    _systems, srvs, _bases = servers
    srv = srvs[1]
    first = srv.batcher
    srv.stop()
    assert srv.batcher is None
    with pytest.raises(RuntimeError, match="closed"):
        first.submit("late query")
    port = srv.start()
    assert srv.batcher is not None and srv.batcher is not first
    code, body = _request(f"http://127.0.0.1:{port}", "/health")
    assert code == 200 and body["status"] == "ok"


class FakeEngine:
    """Records batch shapes; returns per-text markers."""

    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def query_batch(self, texts, max_results=5, similarity_threshold=None,
                    source_filters=None, metadata_filters=None):
        if self.fail:
            raise RuntimeError("backend down")
        time.sleep(0.01)
        self.calls.append((list(texts), max_results, similarity_threshold,
                           tuple(source_filters or ())))
        return [f"res:{t}:k{max_results}" for t in texts]


def _drive_batcher(Batcher, fail=False):
    eng = FakeEngine(fail=fail)
    b = Batcher(eng, window_ms=40, max_batch=8)
    results, errors = {}, {}

    def worker(i):
        try:
            results[i] = b.submit(f"q{i}", max_results=3 if i % 3 else 5,
                                  source_filters=("notes",) if i % 5 == 0 else None)
        except RuntimeError as exc:
            errors[i] = str(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(20)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("after close")
    groups = sorted((len(c[0]), c[1], c[3]) for c in eng.calls)
    return results, errors, groups, b.stats


def test_query_batcher_parity():
    for fail in (False, True):
        jr, je, jg, js = _drive_batcher(JBatcher, fail)
        pr, pe, pg, ps = _drive_batcher(PBatcher, fail)
        assert pr == jr and pe == je
        assert ps["queries"] == js["queries"] == 20
        if fail:
            assert set(pe) == set(range(20)) and set(pe.values()) == {"backend down"}
        else:
            assert pr == {i: f"res:q{i}:k{3 if i % 3 else 5}" for i in range(20)}
            # grouped by parameters, split at max_batch, fewer flushes than queries
            assert all(n <= 8 for n, _k, _s in pg) and sum(n for n, _k, _s in pg) == 20
            assert ps["flushes"] < 20 and ps["max_flush"] > 1
            assert {(k, s) for _n, k, s in pg} == {(k, s) for _n, k, s in jg}
