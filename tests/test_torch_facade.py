"""The port's host layers above the engine against the JAX package's, on
the CPU: the ``EnhancedRAGSystem`` facade (both API families, capture
ingest, the LLM handoff), the embedding pipeline, the orchestration and
ingest copies, the Ollama encoder, the launcher, profiling and the GUI's
stats text.

The systems use the fake encoder and ``index.tier="auto"`` (below 8192
rows of capacity: the single-pass ``fused_topk_int8`` route, its plain
version here, the Pallas kernel in interpret mode in the JAX package),
fixed texts and seeded timestamps; upload ids come from a counter in
both.  Doc ids must be equal (tie order included), similarities within
1e-5, every other field equal once the time-valued fields are dropped.
``test_fine_tune_from_feedback`` trains the bundled encoder's dense half
in both packages instead (its tolerances are stated there).
"""

import json

import numpy as np
import pytest
import torch

import modular_rag_system_tpu as jpkg
import modular_rag_system_tpu_torch as ppkg
from modular_rag_system_tpu import facade as jfacade
from modular_rag_system_tpu import launcher as jlauncher
from modular_rag_system_tpu.ingest import files as jfiles
from modular_rag_system_tpu_torch import facade as pfacade
from modular_rag_system_tpu_torch import launcher as plauncher
from modular_rag_system_tpu_torch.ingest import files as pfiles
from torch_parity import SeqUUID, assert_same_fields, stub_embedding, stub_ollama

TEXTS = [
    "The roadmap covers retrieval quality, index tiers and scaling.",
    "Glaciers carve U-shaped valleys as they move downhill.",
    "A convex lens bends light rays together to form an image.",
    "Quarterly planning sets the goals of the retrieval team.",
    "Volcanoes form where magma rises through the crust.",
    "The kernel scores int8 rows and keeps the top results.",
]
QUERIES = ["retrieval roadmap", "how do glaciers move?", "lens image",
           "what about quarterly planning?", "kernel top results"]


def _cfg(pkg, root, **extra):
    over = {"embedding.model": "fake", "embedding.dim": 384, "index.tier": "auto",
            "store.storage_path": str(root), "serving.file_server_port": 0,
            "retrieval.similarity_threshold": 0.0, **extra}
    return pkg.RAGConfig.load(overrides=over)


@pytest.fixture()
def systems(tmp_path, monkeypatch):
    monkeypatch.setattr(jfiles, "uuid", SeqUUID())
    monkeypatch.setattr(pfiles, "uuid", SeqUUID())
    j = jfacade.EnhancedRAGSystem(_cfg(jpkg, tmp_path / "jax"), enable_llm=False)
    p = pfacade.EnhancedRAGSystem(_cfg(ppkg, tmp_path / "port"), enable_llm=False,
                                  device="cpu")
    yield j, p
    j.shutdown()
    p.shutdown()


def _stats(system, root):
    st = system.get_system_stats()
    assert st["engine"]["store"].pop("db_path") == str(root / "documents.db")
    st["engine"]["index"].pop("device", None)  # the port's stats name it
    return st


def test_facade_flows_parity(systems, tmp_path):
    jsys, psys = systems
    src = tmp_path / "in"
    src.mkdir()
    (src / "roadmap_notes.txt").write_text("\n\n".join(TEXTS[:3]))
    (src / "planning-volcanoes.md").write_text("\n\n".join(TEXTS[3:]))
    (src / "facts.json").write_text(json.dumps({"facts": TEXTS[1:4]}))
    for f in sorted(src.iterdir()):
        rj, rp = jsys.add_file_from_path(str(f)), psys.add_file_from_path(str(f))
        assert_same_fields(rj.to_dict(), rp.to_dict())
    assert jsys.add_file_from_path(str(src / "absent.txt")) is None
    assert psys.add_file_from_path(str(src / "absent.txt")) is None
    for q in QUERIES:
        out = psys.query_with_files(q)
        assert out["results"]
        assert_same_fields(jsys.query_with_files(q), out)

    for s in systems:
        s.add_context_switch("editor", "browser")
        s.add_context_switch("editor", "browser")
        s.add_context_switch("browser", "terminal")
        s.record_feedback("retrieval roadmap", "positive")
        s.record_feedback("lens image", "negative")
    for q, app, content in (("what about the retrieval roadmap?", "editor",
                             "editing the roadmap for retrieval"),
                            ("explain glaciers", "", ""),
                            ("what about the retrieval roadmap?", "editor", "")):
        resp = psys.enhanced_query(q, current_app=app, current_content=content)
        assert_same_fields(jsys.enhanced_query(q, current_app=app, current_content=content),
                           resp)
    assert resp["from_cache"]  # the repeated question is served from the cache

    # capture ingest: keystrokes (seeded timestamps) and OCR
    rng = np.random.default_rng(3)
    typed = "typing notes about int8 kernels and retrieval"
    stamps = 1.7e9 + np.cumsum(rng.uniform(0.05, 0.3, len(typed)))
    from modular_rag_system_tpu.ingest.ocr import stub_backend as jstub
    from modular_rag_system_tpu_torch.ingest.ocr import stub_backend as pstub

    for s, stub in ((jsys, jstub), (psys, pstub)):
        kc = s.enable_keystroke_capture()
        for ch, t in zip(typed, stamps):
            kc.feed_event(ch if ch != " " else "space", application="editor",
                          timestamp=float(t))
        kc.drain()
        assert s.enable_ocr(stub("screen text about dashboards", 0.95), start=False).poll_once()
    for q in ("int8 kernels", "dashboards"):
        assert_same_fields(jsys.query_with_files(q), psys.query_with_files(q))
    res = [s.engine.query("int8 kernels retrieval", max_results=3) for s in systems]
    assert [d.id for d in res[0].documents] == [d.id for d in res[1].documents]
    assert any(d.content_type == "keystroke" for d in res[1].documents)
    assert_same_fields(psys.aggregator.recent("ocr"), jsys.aggregator.recent("ocr"))
    assert_same_fields(_stats(jsys, tmp_path / "jax"), _stats(psys, tmp_path / "port"))


def test_facade_llm_handoff_parity(tmp_path):
    from modular_rag_system_tpu.llm import OllamaClient as JClient
    from modular_rag_system_tpu_torch.llm import OllamaClient as PClient

    with stub_ollama() as url:
        pc = PClient(base_url=url)
        assert pc.available and pc.generate("twelve chars") == \
            "An answer from 12 prompt chars."
        jsys = jfacade.EnhancedRAGSystem(_cfg(jpkg, tmp_path / "jax"),
                                         llm_client=JClient(base_url=url))
        psys = pfacade.EnhancedRAGSystem(_cfg(ppkg, tmp_path / "port"), llm_client=pc,
                                         device="cpu")
        try:
            for s in (jsys, psys):
                for t in TEXTS:
                    s.engine.add_document(t, source="notes", metadata={"n": len(t)})
            resp = psys.enhanced_query("what about the roadmap?")
            assert "### Analysis" in resp["insight"]
            assert_same_fields(jsys.enhanced_query("what about the roadmap?"), resp)
            assert psys.processor.stats == jsys.processor.stats
            assert psys.processor.stats["llm_calls"] == 1
        finally:
            jsys.shutdown()
            psys.shutdown()


def test_build_llm_client_parity(tmp_path):
    from modular_rag_system_tpu.llm import build_llm_client as jbuild
    from modular_rag_system_tpu_torch.llm import Llama3CliClient, OllamaClient
    from modular_rag_system_tpu_torch.llm import build_llm_client as pbuild

    with stub_ollama() as url:
        over = {"serving.ollama_base_url": url, "serving.llm_timeout_s": 5.0}
        client = pbuild(_cfg(ppkg, tmp_path, **over))
        assert isinstance(client, OllamaClient) and client.base_url == url
        assert type(jbuild(_cfg(jpkg, tmp_path, **over))).__name__ == "OllamaClient"
    # nothing answers on port 1 and no llama3-cli binary is installed
    over = {"serving.ollama_base_url": "http://127.0.0.1:1"}
    assert pbuild(_cfg(ppkg, tmp_path, **over)) is None
    assert jbuild(_cfg(jpkg, tmp_path, **over)) is None
    assert not Llama3CliClient(binary="no-such-llama3-cli").available


def test_ollama_encoder_parity(tmp_path):
    from modular_rag_system_tpu.models import build_encoder as jbuild
    from modular_rag_system_tpu_torch.models import build_encoder as pbuild

    with stub_ollama(dim=64) as url:
        over = {"embedding.model": "ollama", "embedding.dim": 64,
                "serving.ollama_base_url": url}
        penc, jenc = pbuild(_cfg(ppkg, tmp_path, **over)), jbuild(_cfg(jpkg, tmp_path, **over))
        assert penc.name == jenc.name == "ollama:nomic-embed-text"
        emb = penc.encode(["hello", "world"])
        np.testing.assert_array_equal(emb, jenc.encode(["hello", "world"]))
        want = np.asarray(stub_embedding("world", 64), np.float32)
        np.testing.assert_allclose(emb[1], want / np.linalg.norm(want), rtol=1e-6)
        np.testing.assert_array_equal(penc.encode_queries(["hello"]), emb[:1])
        # an engine on it: the same answers as the JAX engine's
        peng = ppkg.create_engine(_cfg(ppkg, tmp_path / "p", **over), device="cpu")
        jeng = jpkg.create_engine(_cfg(jpkg, tmp_path / "j", **over))
        for e in (peng, jeng):
            for t in TEXTS:
                e.add_document(t)
        pr, jr = peng.query_batch(QUERIES, max_results=3), jeng.query_batch(QUERIES, max_results=3)
        for a, b in zip(jr, pr):
            assert [d.id for d in a.documents] == [d.id for d in b.documents]
            np.testing.assert_allclose(a.similarities, b.similarities, rtol=0, atol=1e-5)
    over["serving.ollama_base_url"] = "http://127.0.0.1:1"
    with pytest.raises(RuntimeError, match="unreachable"):
        pbuild(_cfg(ppkg, tmp_path, **over))


def test_pipeline_parity():
    from modular_rag_system_tpu.chunker import TextChunker as JChunker
    from modular_rag_system_tpu.models.fake import FeatureHashEncoder as JFake
    from modular_rag_system_tpu.pipeline import EmbeddingPipeline as JPipe
    from modular_rag_system_tpu_torch.chunker import TextChunker as PChunker
    from modular_rag_system_tpu_torch.models.fake import FeatureHashEncoder as PFake
    from modular_rag_system_tpu_torch.pipeline import EmbeddingPipeline as PPipe

    long_text = "\n\n".join(TEXTS * 6)
    outs = []
    for Pipe, Chunker, Fake in ((JPipe, JChunker, JFake), (PPipe, PChunker, PFake)):
        pipe = Pipe(Fake(dim=64), Chunker(chunk_size_tokens=24, overlap_tokens=4),
                    cache_size=10)
        single = pipe.process_content(long_text, "document", {"origin": "test"})
        batch = pipe.batch_process([{"content": t, "metadata": {"i": i}}
                                    for i, t in enumerate(TEXTS + TEXTS[:2])]
                                   + [{"content": long_text, "content_type": "ocr"}])
        docs = pipe.create_rag_documents(single, source="notes", importance=0.5)
        outs.append((single, batch, docs, pipe.get_stats(), list(pipe._cache)))
    (js, jb, jd, jst, jc), (ps, pb, pd, pst, pc) = outs
    assert len(ps) > 1 and len(pc) <= 10  # chunked, and the cache evicted

    def rows(results):
        return [{**r.__dict__, "embedding": np.asarray(r.embedding).tolist()}
                for r in results]

    assert_same_fields(rows(js), rows(ps))
    assert_same_fields([rows(r) for r in jb], [rows(r) for r in pb])
    assert_same_fields([d.to_dict(include_embedding=True) for d in jd],
                       [d.to_dict(include_embedding=True) for d in pd])
    assert_same_fields(jst, pst)
    assert jc == pc


def test_microbatcher_parity(tmp_path):
    out = []
    for pkg, fac, kw in ((jpkg, jfacade, {}), (ppkg, pfacade, {"device": "cpu"})):
        s = fac.EnhancedRAGSystem(_cfg(pkg, tmp_path / pkg.__name__), enable_llm=False,
                                  capture_batch_size=3, **kw)
        try:
            for i, t in enumerate(TEXTS[:5]):
                s._capture_sink(t, {"application": f"app{i % 2}",
                                    "content_type": "keystroke"})
            flushed = dict(s.batcher.stats)
            s.batcher.stop()
            res = s.engine.query_batch(QUERIES, max_results=4)
            out.append((flushed, dict(s.batcher.stats),
                        [[(d.id, d.source) for d in r.documents] for r in res],
                        [r.similarities for r in res]))
        finally:
            s.shutdown()
    (jf, js, jids, jsims), (pf, ps, pids, psims) = out
    assert pf == jf == {"items": 5, "flushes": 1, "documents_added": 3}
    assert ps == js and ps["documents_added"] == 5
    assert pids == jids
    for a, b in zip(jsims, psims):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_orchestration_and_ingest_copies_parity(tmp_path):
    from modular_rag_system_tpu.ingest import keystrokes as jks
    from modular_rag_system_tpu.ingest import privacy as jpriv
    from modular_rag_system_tpu.orchestration import aggregator as jagg
    from modular_rag_system_tpu.orchestration import enhancements as jenh
    from modular_rag_system_tpu_torch.ingest import keystrokes as pks
    from modular_rag_system_tpu_torch.ingest import privacy as ppriv
    from modular_rag_system_tpu_torch.orchestration import aggregator as pagg
    from modular_rag_system_tpu_torch.orchestration import enhancements as penh

    def run(agg, enh, priv, ks):
        pf = priv.PrivacyFilter()
        a = agg.ContextAggregator()
        a.add_keystroke_context("drafting the int8 kernel notes", {"application": "editor"})
        a.add_ocr_context("dashboard shows latency", {"application": "browser"})
        ctx = a.build_query_context("how do I fix the kernel?")
        bridge, pred, learn = (enh.CrossAppContextBridge(), enh.PredictiveContextSwitcher(),
                               enh.LearningAdaptationSystem())
        bridge.add_context("editor", "kernel notes about int8 rows")
        bridge.add_context("browser", "kernel benchmark page")
        for f, t in (("editor", "browser"), ("editor", "browser"), ("browser", "shell")):
            pred.record_context_switch(f, t)
        learn.record_feedback("kernel notes", "positive")
        learn.record_feedback("kernel notes", "followed")
        captured = []
        cap = ks.KeystrokeCapture(privacy=pf, rag_callback=lambda c, m: captured.append((c, m)))
        for i, ch in enumerate("my password is hunter2"):
            cap.feed_event(ch if ch != " " else "space", application="editor",
                           timestamp=1.7e9 + i * 0.1)
        for i, ch in enumerate("notes on retrieval kernels x\b"):
            cap.feed_event(ch if ch != " " else "space", application="notes",
                           timestamp=1.8e9 + i * 0.1)
        cap.drain()
        cap.export_sessions(str(tmp_path / f"{ks.__name__}.json"))
        exported = json.loads((tmp_path / f"{ks.__name__}.json").read_text())
        return {"ctx": {k: v for k, v in ctx.__dict__.items()},
                "recent": a.recent("keystroke"),
                "bridged": bridge.get_bridged_context("kernel notes"),
                "predicted": pred.predict_next_context("editor"),
                "adjust": learn.get_response_adjustments("kernel notes"),
                "anon": pf.anonymize_text("mail a@b.com or call 555-123-4567"),
                "blocked": [pf.should_block_application(app, title) for app, title in
                            (("1Password", ""), ("editor", "Login page"), ("editor", ""))],
                "captured": captured, "sessions": exported["sessions"],
                "ks_stats": cap.get_statistics()}

    assert_same_fields(run(jagg, jenh, jpriv, jks), run(pagg, penh, ppriv, pks))


# feedback pairs: queries and the documents they were answered with
FEEDBACK = [("retrieval roadmap", TEXTS[0]), ("how do glaciers move?", TEXTS[1]),
            ("lens image", TEXTS[2]), ("quarterly planning goals", TEXTS[3]),
            ("where does magma rise?", TEXTS[4]), ("kernel top results", TEXTS[5]),
            ("valleys carved by ice", TEXTS[1]), ("light rays and images", TEXTS[2])]


def test_fine_tune_from_feedback(tmp_path):
    # the early returns: an encoder that cannot train (the fake one)
    for pkg, fac, kw in ((jpkg, jfacade, {}), (ppkg, pfacade, {"device": "cpu"})):
        s = fac.EnhancedRAGSystem(_cfg(pkg, tmp_path / pkg.__name__), enable_llm=False, **kw)
        try:
            for i in range(8):
                s.record_feedback(f"q{i}", "positive", matched_content=f"c{i}")
            assert s.fine_tune_from_feedback() is None
        finally:
            s.shutdown()
    # the bundled hybrid encoder's dense half, trained on the same pairs by
    # both packages (JAX: the 8 virtual devices, a (4, 2) mesh; the port:
    # one device), f32 at 32 tokens.  Tolerances: the metrics' loss within
    # 2e-5 (3 steps at lr 1e-3 move the f32 weights apart by ~1e-5), the
    # accuracy and counts equal; after the re-embedding, a query's ids
    # equal and its similarities within 5e-5.
    over = {"embedding.model": "auto", "embedding.dtype": "float32",
            "embedding.max_seq_len": 32}
    j = jfacade.EnhancedRAGSystem(_cfg(jpkg, tmp_path / "j", **over), enable_llm=False)
    p = pfacade.EnhancedRAGSystem(_cfg(ppkg, tmp_path / "p", **over), enable_llm=False,
                                  device="cpu")
    try:
        out = {}
        for name, pkg, s in (("jax", jpkg, j), ("port", ppkg, p)):
            s.engine.add_documents([pkg.Document(content=t, timestamp=1.7e9 + i)
                                    for i, t in enumerate(TEXTS)])
            s.record_feedback("q", "positive", matched_content="c")
            assert s.fine_tune_from_feedback(min_pairs=4) is None  # too few pairs
            assert s._training_pairs == [("q", "c")]  # nothing consumed
            s._training_pairs.clear()
            for q, d in FEEDBACK:
                s.record_feedback(q, "positive", matched_content=d)
            before = s.engine.query_batch(QUERIES, max_results=3, similarity_threshold=0.0)
            metrics = s.fine_tune_from_feedback(steps=3, learning_rate=1e-3)
            assert s._training_pairs == []
            after = s.engine.query_batch(QUERIES, max_results=3, similarity_threshold=0.0)
            out[name] = metrics, before, after
        (jm, jb, ja), (pm, pb, pa) = out["jax"], out["port"]
        assert pm["final_loss"] == pytest.approx(jm["final_loss"], abs=2e-5)
        assert {k: v for k, v in pm.items() if k != "final_loss"} == {
            k: v for k, v in jm.items() if k != "final_loss"}
        assert pm["pairs"] == 8 and pm["steps"] == 3 and pm["rows_reembedded"] == len(TEXTS)
        for jr, pr in ((jb, pb), (ja, pa)):
            for a, b in zip(jr, pr, strict=True):
                assert [d.id for d in a.documents] == [d.id for d in b.documents]
                np.testing.assert_allclose(b.similarities, a.similarities, rtol=0, atol=5e-5)
        # the weights moved: the answers' similarities changed
        assert max(abs(x - y) for a, b in zip(pb, pa) for x, y in
                   zip(a.similarities, b.similarities)) > 1e-3
    finally:
        j.shutdown()
        p.shutdown()


# ---------------------------------------------------------------- launcher
def test_launcher_self_test_on_both_packages(tmp_path, capsys):
    # the default configuration: the bundled hybrid encoder
    assert plauncher.main(["--test", "--device", "cpu", "--storage", str(tmp_path / "p"),
                           "--port", "0"]) == 0
    assert "self-test: PASSED" in capsys.readouterr().out
    assert jlauncher.main(["--test", "--storage", str(tmp_path / "j"), "--port", "0"]) == 0
    assert "self-test: PASSED" in capsys.readouterr().out


@pytest.mark.parametrize("mode", [["--query", "what about glaciers?"], ["--init-only"]])
def test_launcher_modes_parity(tmp_path, capsys, mode):
    outs = []
    for pkg, launcher, dev in ((jpkg, jlauncher, []), (ppkg, plauncher, ["--device", "cpu"])):
        root = tmp_path / pkg.__name__
        eng = pkg.create_engine(_cfg(pkg, root), **({"device": "cpu"} if dev else {}))
        for i, t in enumerate(TEXTS):
            eng.add_documents([pkg.Document(content=t, timestamp=1.7e9 + i)])
        eng.shutdown()
        capsys.readouterr()
        assert launcher.main([*mode, "--storage", str(root), "--encoder", "fake",
                              "--port", "0", "--tier", "int8", *dev]) == 0
        outs.append(capsys.readouterr().out)
    if mode[0] == "--query":
        assert "## Insight for: what about glaciers?" in outs[1]
        assert outs[0] == outs[1]
    else:
        js, ps = (json.loads(o) for o in outs)
        for st, root in ((js, tmp_path / jpkg.__name__), (ps, tmp_path / ppkg.__name__)):
            assert st["engine"]["store"].pop("db_path") == str(root / "documents.db")
        assert ps["engine"]["index"].pop("device") == "cpu"
        assert_same_fields(js, ps)


def test_launcher_flags(tmp_path):
    args = plauncher.build_arg_parser().parse_args(
        ["--tier", "int8", "--storage", str(tmp_path), "--shards", "2", "--device", "cpu"])
    cfg = plauncher.load_config(args)
    assert (cfg.index.tier, cfg.store.storage_path, cfg.mesh.index_shards, args.device) == \
        ("int8", str(tmp_path), 2, "cpu")
    assert plauncher.build_arg_parser().parse_args([]).device == "cuda"
    init = ["--init-only", "--storage", str(tmp_path), "--encoder", "fake", "--port", "0",
            "--device", "cpu"]
    # --shards builds the sharded index (two shards on the CPU here)
    assert plauncher.main([*init, "--shards", "2"]) == 0
    # --multihost joins a process group in the engine: driven in a child
    # process by tests/test_torch_multihost.py::test_launcher_multihost_init_only
    args = plauncher.build_arg_parser().parse_args([*init, "--multihost"])
    assert plauncher.load_config(args).mesh.multihost is True


def test_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfacade.EnhancedRAGSystem(_cfg(ppkg, tmp_path / "f"), enable_llm=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plauncher.main(["--test", "--storage", str(tmp_path / "l"), "--encoder", "fake",
                        "--port", "0"])


# ---------------------------------------------------------------- the rest
def test_package_surface():
    assert ppkg.__version__ == jpkg.__version__ == "0.5.0"
    for name in ("Chunk", "EmbeddingResult", "Document", "Query", "RetrievalResult"):
        assert name in ppkg.__all__ and name in jpkg.__all__
        assert [f for f in getattr(ppkg, name).__dataclass_fields__] == \
            [f for f in getattr(jpkg, name).__dataclass_fields__]


def test_profiling(tmp_path):
    from modular_rag_system_tpu.utils.profiling import TimingRegistry as JReg
    from modular_rag_system_tpu_torch.utils.profiling import TimingRegistry, device_trace

    regs = TimingRegistry(window=4), JReg(window=4)
    for reg in regs:
        for x in (0.5, 0.1, 0.3, 0.2, 0.4):
            reg.record("stage", x)
    assert regs[0].stats() == regs[1].stats()
    assert regs[0].stats()["stage"]["count"] == 5
    with device_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_gui_stats_text_parity(systems, tmp_path):
    from modular_rag_system_tpu.gui import format_stats as jformat
    from modular_rag_system_tpu_torch import gui

    for s in systems:
        s.engine.add_document("stats render probe", source="test")
        s.engine.query("probe")
    jst, pst = (_stats(s, tmp_path / r) for s, r in zip(systems, ("jax", "port")))
    jst["timestamp"] = pst["timestamp"] = 0.0
    for st in (jst, pst):
        st["engine"]["query_stats"]["avg_retrieval_time"] = 0.0
        st["pipeline"]["avg_processing_time"] = 0.0
        st["engine"]["store"]["oldest_timestamp"] = st["engine"]["store"]["newest_timestamp"] = 0
    # the one wording change: the index lives in device memory, not HBM
    assert gui.format_stats(pst) == jformat(jst).replace("MB HBM)", "MB device)")
    assert "total documents:    1" in gui.format_stats(pst)
    if not gui.tkinter_available():
        with pytest.raises(RuntimeError, match="CLI"):
            gui.launch_gui(object())


def test_keystrokes_cli_and_window_tracker_parity(tmp_path, capsys):
    from modular_rag_system_tpu.ingest import keystrokes as jks
    from modular_rag_system_tpu.ingest.windows import WindowTracker as JTracker
    from modular_rag_system_tpu_torch.ingest import keystrokes as pks
    from modular_rag_system_tpu_torch.ingest.windows import WindowTracker as PTracker

    outs = []
    for ks in (jks, pks):
        assert ks._main(["--test"]) == 0
        assert ks._main(["--stats", "--export", str(tmp_path / f"{ks.__name__}.json")]) == 0
        outs.append(capsys.readouterr().out.replace(str(tmp_path), "<tmp>")
                    .replace(ks.__name__, "<ks>"))
    assert outs[0] == outs[1] and "self-test: PASSED" in outs[1]
    trackers = [T(min_interval_s=0.0) for T in (JTracker, PTracker)]
    for t in trackers:  # no window tool: the fallback chain ends at Unknown
        t._xdotool = t._wmctrl = None
    infos = [t.get_active_window_info() for t in trackers]
    assert infos[0] == infos[1] == {"application": "Unknown", "window_title": "Unknown"}
    assert not trackers[1].available
