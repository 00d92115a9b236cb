"""The port's RAGEngine against the JAX package's, on the CPU.

Both engines get the same config (bundled hybrid encoder at float32,
``tier="auto"``, no recency weight, no threshold), the same knowledge
texts and the same queries.  Below 8192 rows of capacity the int8 tier
takes the single-pass route (``fused_topk_int8`` + master rescore);
padded with pre-embedded rows to capacity 8192 it takes the two-pass
route (``binmax_int8`` + master slab rescore).  Returned doc ids must be
equal and similarities within 1e-5 (the encoders agree to ~1e-7, the
master rescores to f32 summation order).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from modular_rag_system_tpu.config import RAGConfig as JaxConfig
from modular_rag_system_tpu.engine import RAGEngine as JaxEngine
from modular_rag_system_tpu.types import Document as JaxDocument
from modular_rag_system_tpu_torch import RAGConfig, create_engine
from modular_rag_system_tpu_torch.types import Document

_TRAIN = Path(__file__).resolve().parents[1] / "modular_rag_system_tpu" / "assets" / "train"
KNOWLEDGE_ALL = json.loads((_TRAIN / "knowledge.json").read_text())["sentences"]
KNOWLEDGE = KNOWLEDGE_ALL[:200]
QUERIES = [it["query"] for it in json.loads((_TRAIN / "qa_pairs.json").read_text())["items"][:6]]


def _overrides(path):
    return {"index.tier": "auto", "embedding.dtype": "float32",
            "retrieval.time_weight": 0.0, "retrieval.similarity_threshold": 0.0,
            "store.storage_path": str(path)}


def _port(path, **extra):
    return create_engine(RAGConfig.load(overrides={**_overrides(path), **extra}),
                         device="cpu")


def _assert_same(jres, pres):
    for j, p in zip(jres, pres):
        assert [d.id for d in j.documents] == [d.id for d in p.documents]
        np.testing.assert_allclose(j.similarities, p.similarities, rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", ["single", "twopass"])
def test_engine_parity_with_jax(tmp_path, monkeypatch, route):
    jeng = JaxEngine(JaxConfig.load(overrides=_overrides(tmp_path / "jax")))
    peng = _port(tmp_path / "port")
    jeng.add_documents([JaxDocument(content=t) for t in KNOWLEDGE])
    peng.add_documents([Document(content=t) for t in KNOWLEDGE])
    if route == "twopass":
        # near-duplicates of the corpus rows, so the extra rows compete
        rng = np.random.default_rng(7)
        emb = np.asarray(jeng.index.E[: len(KNOWLEDGE)], np.float32)
        fill = emb[rng.integers(0, len(KNOWLEDGE), 4000)]
        fill = fill + 0.3 * rng.standard_normal(fill.shape).astype(np.float32) / np.sqrt(768)
        fill /= np.linalg.norm(fill, axis=1, keepdims=True)
        jeng.add_documents([JaxDocument(content=f"filler {i}", embedding=e)
                            for i, e in enumerate(fill)])
        peng.add_documents([Document(content=f"filler {i}", embedding=e)
                            for i, e in enumerate(fill)])
    assert peng.index.capacity == jeng.index.capacity == (8192 if route == "twopass" else 4096)
    assert peng.index.count == jeng.index.count
    from modular_rag_system_tpu_torch import index as pindex

    called = []
    for name in ("twopass_topk_int8_master_raw", "fused_topk_int8_raw"):
        fn = getattr(pindex, name)
        monkeypatch.setattr(pindex, name,
                            lambda *a, _fn=fn, _n=name, **kw: called.append(_n) or _fn(*a, **kw))
    _assert_same(jeng.query_batch(QUERIES, max_results=5),
                 peng.query_batch(QUERIES, max_results=5))
    _assert_same([jeng.query(QUERIES[0])], [peng.query(QUERIES[0])])
    assert set(called) == {"twopass_topk_int8_master_raw" if route == "twopass"
                           else "fused_topk_int8_raw"}


def test_delete_readd_and_restart(tmp_path):
    eng = _port(tmp_path)
    eng.add_documents([Document(content=t) for t in KNOWLEDGE[:50]])
    ids = eng.add_text("Volcanoes form where magma rises through the crust.\n\n"
                       "Glaciers carve U-shaped valleys as they move.", source="geo")
    assert len(ids) == 1 and eng.index.count == 51
    target = Document(content="Glaciers and volcanoes shape unusual landscapes.")
    eng.add_documents([target])
    row = eng.store.row_of(target.id)
    eng.store.delete_ids([target.id])
    eng.index.delete_rows(np.array([row]))
    res = eng.query("glaciers volcanoes landscapes", max_results=3)
    assert target.id not in [d.id for d in res.documents]
    eng.add_document(target.content)  # resurrected in place
    res = eng.query("glaciers volcanoes landscapes", max_results=1)
    assert res.documents[0].id == target.id and eng.index.count == 52
    before = eng.query_batch(QUERIES, max_results=3)
    stats = eng.get_system_stats()
    assert stats["index"]["effective_tier"] == "int8" and stats["index"]["count"] == 52
    eng.shutdown()
    eng2 = _port(tmp_path)
    assert eng2.index.count == 52
    _assert_same(before, eng2.query_batch(QUERIES, max_results=3))


@pytest.mark.parametrize("extra", [{"mesh.multihost": True, "mesh.index_shards": 2},
                                   {"mesh.multihost": True}])
def test_multihost_engine_in_a_one_process_group(tmp_path, extra):
    """``mesh.multihost`` joins a process group (here one process, from
    the RAG_* variables, in a fresh interpreter: no group outlives the
    test) and builds the one-process layout, whose answers equal the
    same engine's without it."""
    import os
    import subprocess
    import sys

    from modular_rag_system_tpu_torch.parallel.mh_check import free_port

    env = dict(os.environ, RAG_COORDINATOR=f"127.0.0.1:{free_port()}",
               RAG_NUM_PROCESSES="1", RAG_PROCESS_ID="0")
    prog = f"""
import json
from modular_rag_system_tpu_torch import RAGConfig, create_engine
from modular_rag_system_tpu_torch.parallel import multihost
from modular_rag_system_tpu_torch.types import Document
texts = json.loads({json.dumps(json.dumps(KNOWLEDGE[:40]))})
out = []
for mh, path in ((True, {str(tmp_path / "mh")!r}), (False, {str(tmp_path / "plain")!r})):
    over = {{**{_fake(tmp_path, **extra)!r}, "store.storage_path": path,
             "mesh.multihost": mh}}
    eng = create_engine(RAGConfig.load(overrides=over), device="cpu")
    eng.add_documents([Document(content=t) for t in texts])
    res = eng.query_batch(["household pets", "stock market"], max_results=3)
    out.append([type(eng.index).__name__, eng.index.count, multihost.is_initialized(),
                [[d.id for d in r.documents] for r in res]])
    eng.shutdown()
print(json.dumps(out))
"""
    proc = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True,
                          text=True, timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-2000:]
    (mh_kind, mh_count, live, mh_ids), (kind, count, _, ids) = json.loads(
        proc.stdout.strip().splitlines()[-1])
    assert live and mh_kind == kind == ("ShardedIndex" if "mesh.index_shards" in extra
                                        else "DeviceIndex")
    assert mh_count == count == 40 and mh_ids == ids


# ---------------------------------------------------------------- sharded
def _fake(path, **extra):
    return {"embedding.model": "fake", "embedding.dim": 384, "store.storage_path": str(path),
            "retrieval.similarity_threshold": 0.0, "retrieval.time_weight": 0.0, **extra}


def _fields(results):
    """query_batch results as JSON-like fields (``assert_same_fields``)."""
    return [{"ids": [d.id for d in r.documents], "sources": [d.source for d in r.documents],
             "similarities": list(r.similarities),
             "total_documents_searched": r.total_documents_searched} for r in results]


def _sharded_pair(tmp_path, shards, **extra):
    """The JAX engine with ``mesh.index_shards`` on the 8 virtual CPU
    devices, and the port's with the same shards on the CPU."""
    from modular_rag_system_tpu.parallel.sharded import ShardedIndex as JaxSharded
    from modular_rag_system_tpu_torch.parallel.sharded import ShardedIndex

    over = _fake(tmp_path / "jax", **{"mesh.index_shards": shards, **extra})
    jeng = JaxEngine(JaxConfig.load(overrides=over))
    over = _fake(tmp_path / "port", **{"mesh.index_shards": shards, **extra})
    peng = create_engine(RAGConfig.load(overrides=over), device="cpu")
    assert isinstance(jeng.index, JaxSharded) and isinstance(peng.index, ShardedIndex)
    assert peng.index.S == jeng.index.S == shards
    return jeng, peng


_CORPUS = [(t, ["animals", "tech", "finance"][i % 3]) for i, t in enumerate(KNOWLEDGE[:120])]
_QUESTIONS = ["programming language machine learning", "household pets", "stock market",
              *QUERIES[:3]]


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_engine_parity_with_jax(tmp_path, shards):
    from tests.torch_parity import assert_same_fields

    jeng, peng = _sharded_pair(tmp_path, shards, **{"index.tier": "exact"})
    for eng, Doc in ((jeng, JaxDocument), (peng, Document)):
        eng.add_documents([Doc(content=t, source=src) for t, src in _CORPUS])
    assert peng.index.count == jeng.index.count == len(_CORPUS)

    def both(**kw):
        assert_same_fields(_fields(jeng.query_batch(_QUESTIONS, **kw)),
                           _fields(peng.query_batch(_QUESTIONS, **kw)))

    both(max_results=5)
    both(max_results=3, source_filters=["finance"])
    # a filter that few rows pass, asking 300 results: k = 1,200 > 1,024
    # from the first pass, so the deep refill serves it through
    # search_deep (exact per shard + the merge), then deepens to count
    for eng, Doc in ((jeng, JaxDocument), (peng, Document)):
        eng.add_documents([Doc(content=t, source="filler") for t in KNOWLEDGE_ALL[120:1320]])
        eng.add_documents([Doc(content=f"rare note {i}", source="rare") for i in range(3)])
    both(max_results=300, source_filters=["rare"])
    assert_same_fields(jeng.get_system_stats()["index"]["count"],
                       peng.get_system_stats()["index"]["count"])
    # the lifecycle rebuilds a sharded index of the same layout
    for eng in (jeng, peng):
        eng.store.delete_ids([eng.store.get_by_rows([4])[0].id])
        eng.index.delete_rows(np.array([4]))
    assert peng.compact() == jeng.compact() == 1
    assert peng.index.S == shards and peng.index.devices == [torch.device("cpu")] * shards
    both(max_results=5)
    assert peng.reembed_all() == jeng.reembed_all()
    both(max_results=300, source_filters=["rare"])
    jeng.shutdown()
    peng.shutdown()


def test_sharded_engine_bundled_encoder(tmp_path, monkeypatch):
    # the device query path (embed, then each shard's search and the
    # merge) with the bundled encoder: 2 shards of capacity 2048, the
    # int8 single-pass route on each, against the JAX engine
    from modular_rag_system_tpu_torch import index as pindex

    extra = {"mesh.index_shards": 2}
    jeng = JaxEngine(JaxConfig.load(overrides={**_overrides(tmp_path / "jax"), **extra}))
    peng = _port(tmp_path / "port", **extra)
    jeng.add_documents([JaxDocument(content=t) for t in KNOWLEDGE])
    peng.add_documents([Document(content=t) for t in KNOWLEDGE])
    called = []
    fn = pindex.fused_topk_int8_raw
    monkeypatch.setattr(pindex, "fused_topk_int8_raw",
                        lambda *a, **kw: called.append(1) or fn(*a, **kw))
    _assert_same(jeng.query_batch(QUERIES, max_results=5),
                 peng.query_batch(QUERIES, max_results=5))
    _assert_same([jeng.query(QUERIES[0])], [peng.query(QUERIES[0])])
    assert len(called) == 4  # once per shard and call
    assert peng.get_system_stats()["index"]["effective_tier"] == "int8"


def test_sharded_engine_ivf_parity_with_jax(tmp_path):
    # test_engine.py's ivf-with-shards case: 8 shards, the ivf tier built
    # from the write path, the same answers as the JAX engine; then the
    # tier knobs survive compact and reembed_all on both index kinds
    from tests.torch_parity import assert_same_fields

    ivf = {"index.tier": "ivf", "index.ivf_clusters": 8, "index.ivf_nprobe": 8,
           "index.ivf_rebuild_min": 64, "index.ivf_iters": 4, "index.ivf_refine_extra": 7}
    jeng, peng = _sharded_pair(tmp_path, 8, **ivf)
    for eng, Doc in ((jeng, JaxDocument), (peng, Document)):
        eng.add_documents([Doc(content=t, source=src) for t, src in _CORPUS])
    assert peng.index._ivf2 is not None and jeng.index._ivf2 is not None
    np.testing.assert_allclose(peng.index._ivf2.shards[0].centroids.numpy(),
                               np.asarray(jeng.index._ivf2.centroids), rtol=0, atol=1e-5)
    assert_same_fields(_fields(jeng.query_batch(_QUESTIONS, max_results=5)),
                       _fields(peng.query_batch(_QUESTIONS, max_results=5)))
    assert_same_fields(jeng.get_system_stats()["index"]["ivf"],
                       peng.get_system_stats()["index"]["ivf"])
    jeng.shutdown()
    peng.shutdown()
    for shards in (1, 8):
        eng = create_engine(RAGConfig.load(overrides=_fake(
            tmp_path / f"knobs{shards}", **ivf, **{"mesh.index_shards": shards})), device="cpu")
        eng.add_documents([Document(content=t, source=src) for t, src in _CORPUS[:40]])
        for where in ("init", "compact", "reembed"):
            if where == "compact":
                eng.compact()
            elif where == "reembed":
                eng.reembed_all()
            for key in ("ivf_clusters", "ivf_nprobe", "ivf_iters", "ivf_refine_extra"):
                assert getattr(eng.index, key) == getattr(eng.config.index, key), (where, key)
            assert type(eng.index).__name__ == ("ShardedIndex" if shards > 1 else "DeviceIndex")
        assert eng.query("household pets", max_results=2).documents
        eng.shutdown()


def test_sharded_engine_restart_warm_starts(tmp_path):
    ivf = {"index.tier": "ivf", "index.ivf_clusters": 8, "index.ivf_rebuild_min": 64,
           "mesh.index_shards": 4}
    cfg = RAGConfig.load(overrides=_fake(tmp_path, **ivf))
    eng = create_engine(cfg, device="cpu")
    eng.add_documents([Document(content=t, source=src) for t, src in _CORPUS])
    before = eng.query_batch(_QUESTIONS, max_results=3)
    eng.shutdown()
    # the snapshot restores on another layout and kind, warm-started
    for shards in (4, 2, 1):
        cfg = RAGConfig.load(overrides=_fake(tmp_path, **{**ivf, "mesh.index_shards": shards}))
        eng2 = create_engine(cfg, device="cpu", index_devices=["cpu"] * shards)
        assert eng2.index._ivf2.warm_started and eng2.index.ivf_warmstart is None
        assert [[d.id for d in r.documents] for r in eng2.query_batch(_QUESTIONS, max_results=3)] \
            == [[d.id for d in r.documents] for r in before]
        eng2.config.store.snapshot_on_shutdown = False
        eng2.shutdown()


def test_sharded_engine_layouts(tmp_path, monkeypatch):
    base = _fake(tmp_path / "h", **{"mesh.index_shards": 4, "mesh.dcn_slices": 2})
    eng = create_engine(RAGConfig.load(overrides=base), device="cpu")
    assert eng.index.hierarchical and [len(m) for m in eng.index.mesh] == [2, 2]
    eng.shutdown()
    with pytest.raises(ValueError, match="must divide by dcn_slices"):
        create_engine(RAGConfig.load(overrides={**base, "mesh.dcn_slices": 3}), device="cpu")
    # on cuda without index_devices, 4 shards need 4 visible cards: it
    # raises before the encoder is built, and never doubles up a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = RAGConfig.load(overrides=_fake(tmp_path / "c", **{"mesh.index_shards": 4}))
    with pytest.raises(ValueError, match="only 1 CUDA devices are visible"):
        create_engine(cfg)


@pytest.mark.parametrize("extra", [
    {"embedding.attention_impl": "flash"},
    {"index.tier": "ivf", "index.ivf_fine_dtype": "int4"},
    {"index.tier": "auto", "index.ivf_fine_dtype": "int4"},
])
def test_ported_configurations_serve(tmp_path, extra):
    # the configurations of the last TPU kernels build and serve, and give
    # the JAX engine's answers (ids equal, similarities within 1e-5)
    extra = {**extra, "index.ivf_clusters": 8, "index.ivf_nprobe": 8,
             "index.ivf_rebuild_min": 64}
    # the JAX flash kernel runs in interpret mode, a Python loop over
    # batch rows x heads x layers: that case takes a handful of texts
    flash = "embedding.attention_impl" in extra
    texts, queries = (KNOWLEDGE[:8], QUERIES[:2]) if flash else (KNOWLEDGE, QUERIES)
    jeng = JaxEngine(JaxConfig.load(overrides={**_overrides(tmp_path / "jax"), **extra}))
    peng = _port(tmp_path / "port", **extra)
    jeng.add_documents([JaxDocument(content=t) for t in texts])
    peng.add_documents([Document(content=t) for t in texts])
    _assert_same(jeng.query_batch(queries, max_results=5),
                 peng.query_batch(queries, max_results=5))
    stats = peng.get_system_stats()["index"]
    if extra.get("index.tier") == "ivf":
        assert stats["ivf"]["fine_dtype"] == "int4"
        assert stats["ivf"] == jeng.get_system_stats()["index"]["ivf"]
        # two rows a byte: half of an int8 copy's bytes
        iv = peng.index._ivf2
        assert stats["ivf"]["fine_bytes"] == iv.nblocks * 128 * 768
    elif "index.tier" in extra:  # auto below the crossover: the int8 tier
        assert stats["effective_tier"] == "int8" and stats["ivf"] is None
    else:
        assert peng.encoder.dense.module.attention_impl == "flash"


def test_auto_tier_at_ivf_scale_builds_int4(monkeypatch):
    # at ivf scale "auto" with ivf_fine_dtype="int4" builds the packed copy
    from modular_rag_system_tpu_torch.index import DeviceIndex

    monkeypatch.setattr(DeviceIndex, "_AUTO_IVF_ROWS", 512)
    idx = DeviceIndex(dim=8, tier="auto", ivf_fine_dtype="int4", ivf_clusters=4,
                      ivf_rebuild_min=64, device="cpu")
    rng = np.random.default_rng(5)
    E = rng.standard_normal((600, 8)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    idx.add(E)
    assert idx.effective_tier() == "ivf" and idx._ivf2.fine_dtype == "int4"
    assert idx._ivf2.E_c3.shape[1] == 128 and idx._ivf2.block_cluster is not None
    assert idx.search(E[:3], 1)[1][:, 0].tolist() == [0, 1, 2]


def test_auto_tier_at_ivf_scale_serves_ivf(monkeypatch):
    # at ivf scale "auto" resolves to ivf, served by the fused route over
    # the master until the write path builds
    from modular_rag_system_tpu_torch import index as pindex
    from modular_rag_system_tpu_torch.index import DeviceIndex

    idx = DeviceIndex(dim=8, tier="auto", device="cpu")
    idx.count = DeviceIndex._AUTO_IVF_ROWS
    assert idx.effective_tier() == "ivf"
    monkeypatch.setattr(DeviceIndex, "_AUTO_IVF_ROWS", 512)
    rng = np.random.default_rng(6)
    E = rng.standard_normal((600, 8)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    idx = DeviceIndex(dim=8, tier="auto", ivf_rebuild_min=1 << 20, device="cpu")
    idx.add(E)
    exact = DeviceIndex(dim=8, tier="exact", device="cpu")
    exact.add(E)
    seen = []
    stream = pindex.stream_search_core
    monkeypatch.setattr(pindex, "stream_search_core",
                        lambda rows, scales, *a: seen.append((rows, scales)) or
                        stream(rows, scales, *a))
    assert idx.effective_tier() == "ivf" and idx._ivf2 is None
    _, rows = idx.search_device(torch.from_numpy(E[:4]), 5)
    assert len(seen) == 1 and seen[0][0] is idx.E and seen[0][1] is None
    np.testing.assert_array_equal(rows.numpy(), exact.search(E[:4], 5)[1])


_IVF = {"index.tier": "ivf", "index.ivf_clusters": 8, "index.ivf_nprobe": 8,
        "index.ivf_rebuild_min": 64}


@pytest.mark.parametrize("route", ["fused", "built"])
def test_engine_ivf_parity_with_jax(tmp_path, route):
    # a bf16 master: the fused fallback's products are bf16 in both
    # packages (JAX on the CPU multiplies f32 rows in true f32, the port
    # and the TPU in bf16), so similarities agree within 1e-5
    extra = {**(_IVF if route == "built" else {"index.tier": "ivf"}),
             "index.store_dtype": "bfloat16"}
    jeng = JaxEngine(JaxConfig.load(overrides={**_overrides(tmp_path / "jax"), **extra}))
    peng = _port(tmp_path / "port", **extra)
    jeng.add_documents([JaxDocument(content=t) for t in KNOWLEDGE])
    peng.add_documents([Document(content=t) for t in KNOWLEDGE])
    assert (peng.index._ivf2 is not None) == (route == "built")
    _assert_same(jeng.query_batch(QUERIES, max_results=5),
                 peng.query_batch(QUERIES, max_results=5))
    # with a filter, k = 30 x overfetch 4 passes 64: the fused fallback
    deep = peng.query_batch(QUERIES[:2], max_results=30, source_filters=["unknown"])
    assert all(len(r.documents) == 30 for r in deep)
    _assert_same(jeng.query_batch(QUERIES[:2], max_results=30, source_filters=["unknown"]),
                 deep)
    stats = peng.get_system_stats()["index"]["ivf"]
    if route == "built":
        assert stats == jeng.get_system_stats()["index"]["ivf"]
    else:
        assert stats is None


def test_engine_passes_every_index_knob(tmp_path):
    from modular_rag_system_tpu.engine import _INDEX_TIER_KEYS as JAX_KEYS
    from modular_rag_system_tpu_torch.index import _INDEX_TIER_KEYS

    assert _INDEX_TIER_KEYS == JAX_KEYS
    eng = _port(tmp_path, **{**_IVF, "index.ivf_iters": 4, "index.ivf_tail_frac": 0.5,
                             "index.ivf_refine_extra": 7, "index.ivf_balance": 0.0,
                             "index.ivf_fine_dtype": "int8", "index.block_rows": 2048})
    for key in _INDEX_TIER_KEYS:
        assert getattr(eng.index, key) == getattr(eng.config.index, key), key


def test_engine_ivf_restart_warm_starts(tmp_path):
    eng = _port(tmp_path, **_IVF)
    eng.add_documents([Document(content=t) for t in KNOWLEDGE])
    before = eng.query_batch(QUERIES, max_results=3)
    cents = eng.index._ivf2.centroids.clone()
    eng.shutdown()
    eng2 = _port(tmp_path, **_IVF)
    assert eng2.index._ivf2.warm_started and eng2.index.ivf_warmstart is None
    assert torch.equal(eng2.index._ivf2.centroids, cents)
    _assert_same(before, eng2.query_batch(QUERIES, max_results=3))


def test_default_device_engine_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    cfg = RAGConfig.load(overrides={"embedding.model": "fake",
                                    "store.storage_path": str(tmp_path)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_engine(cfg)


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_snapshot_format_shared_with_jax(tmp_path, store_dtype):
    from modular_rag_system_tpu.index import DeviceIndex as JaxIndex
    from modular_rag_system_tpu_torch.index import DeviceIndex

    rng = np.random.default_rng(3)
    mat = rng.standard_normal((37, 16)).astype(np.float32)
    pidx = DeviceIndex(dim=16, tier="int8", store_dtype=store_dtype, device="cpu")
    pidx.add(mat)
    pidx.delete_rows(np.array([4]))
    pidx.snapshot(str(tmp_path / "port.npz"))
    jidx = JaxIndex.load(str(tmp_path / "port.npz"), tier="exact")
    assert jidx.store_dtype == store_dtype and jidx.count == 37
    np.testing.assert_array_equal(np.asarray(jidx.E[:37], np.float32),
                                  pidx.E[:37].float().numpy())
    jidx.snapshot(str(tmp_path / "jax.npz"))
    back = DeviceIndex.load(str(tmp_path / "jax.npz"), tier="int8", device="cpu")
    assert back.store_dtype == store_dtype and back.count == 37
    assert torch.equal(back.E[:37], pidx.E[:37])
    q = rng.standard_normal((2, 16)).astype(np.float32)
    np.testing.assert_array_equal(back.search(q, 5)[1], pidx.search(q, 5)[1])


def test_store_fetches_rows_in_batches(tmp_path, monkeypatch):
    # a fetch of more rows than one SELECT may bind goes out in batches:
    # the same documents, in the order asked, and every access counted
    from modular_rag_system_tpu.store import DocumentStore as JaxStore
    from modular_rag_system_tpu_torch import store as pstore

    monkeypatch.setattr(pstore, "_IN_BATCH", 64)
    port, ref = pstore.DocumentStore(str(tmp_path / "p")), JaxStore(str(tmp_path / "j"))
    port.upsert_batch([Document(content=f"row {i}", id=f"d{i}") for i in range(300)])
    ref.upsert_batch([JaxDocument(content=f"row {i}", id=f"d{i}") for i in range(300)])
    rows = list(range(299, -1, -3)) + [1000]  # unordered, and one absent row
    got, want = port.get_by_rows(rows), ref.get_by_rows(rows)
    assert [d and (d.id, d.content, d.access_count) for d in got] == \
        [d and (d.id, d.content, d.access_count) for d in want]
    again = port.get_by_rows(rows[:70])
    assert [d.access_count for d in again] == [1] * 70


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_search_deep_matches_jax_exact_topk(tier):
    # the deep refill's exact top-k over the f32 master, whatever the tier,
    # at k past the kernel routes' 1,024: ids equal JAX's, tie order
    # included (quarter-step rows make exact, order-free dot products and
    # many ties)
    import jax.numpy as jnp

    from modular_rag_system_tpu.ops.exact import exact_topk_raw as jax_exact_topk
    from modular_rag_system_tpu_torch.index import DeviceIndex

    rng = np.random.default_rng(11)
    E = rng.integers(-4, 5, (1500, 16)).astype(np.float32) * 0.25
    q = rng.integers(-4, 5, (3, 16)).astype(np.float32) * 0.25
    idx = DeviceIndex(dim=16, tier=tier, device="cpu")
    idx.add(E)
    idx.search(q, 10)  # builds the int8 copy on the int8 tier
    assert (idx._E_q is not None) == (tier == "int8")
    vals, rows = idx.search_deep(q, 1200)
    jv, jr = jax_exact_topk(jnp.asarray(E), jnp.int32(1500), jnp.asarray(q), 1200)
    np.testing.assert_array_equal(rows, np.asarray(jr))
    np.testing.assert_array_equal(vals, np.asarray(jv))
    assert len(np.unique(vals[0])) < 1200  # ties were decided


def test_query_batch_past_the_encoder_batch(tmp_path):
    # past embedding.batch_size the encoder forwards the queries in chunks:
    # each query's answer equals its answer alone
    cfg = RAGConfig.load(overrides={
        "embedding.bundled_checkpoint": "", "embedding.dim": 32, "embedding.num_layers": 1,
        "embedding.num_heads": 2, "embedding.mlp_dim": 64, "embedding.vocab_size": 512,
        "embedding.max_seq_len": 32, "embedding.batch_size": 4, "embedding.dtype": "float32",
        "embedding.lexical_dim": 16, "embedding.lexical_weight": 0.5, "index.tier": "exact",
        "retrieval.similarity_threshold": 0.0, "retrieval.time_weight": 0.0,
        "store.storage_path": str(tmp_path), "store.snapshot_on_shutdown": False})
    eng = create_engine(cfg, device="cpu")
    try:
        eng.add_documents([Document(content=t) for t in KNOWLEDGE[:40]])
        texts = [t[:60] for t in KNOWLEDGE[40:45]]
        assert len(texts) == eng.encoder.dense.batch_size + 1
        batch = eng.query_batch(texts, max_results=5)
        alone = [eng.query(t, max_results=5) for t in texts]
        for b, a in zip(batch, alone):
            assert [d.id for d in b.documents] == [d.id for d in a.documents]
            np.testing.assert_allclose(b.similarities, a.similarities, rtol=0, atol=1e-5)
            assert b.query_embedding is None and a.query_embedding is None
    finally:
        eng.shutdown()


def test_query_batch_past_the_encoder_batch_parity_with_jax(tmp_path):
    # the same 5 queries past embedding.batch_size = 4: the port forwards
    # them in chunks (4 + 1), the JAX engine pads the batch to 8 at once;
    # the answers agree
    extra = {"embedding.batch_size": 4}
    jeng = JaxEngine(JaxConfig.load(overrides={**_overrides(tmp_path / "jax"), **extra}))
    peng = _port(tmp_path / "port", **extra)
    try:
        jeng.add_documents([JaxDocument(content=t) for t in KNOWLEDGE])
        peng.add_documents([Document(content=t) for t in KNOWLEDGE])
        queries = QUERIES[:5]
        assert len(queries) == peng.encoder.dense.batch_size + 1
        pres = peng.query_batch(queries, max_results=5)
        _assert_same(jeng.query_batch(queries, max_results=5), pres)
        assert all(r.query_embedding is None for r in pres)  # the kernel route
    finally:
        jeng.shutdown()
        peng.shutdown()
