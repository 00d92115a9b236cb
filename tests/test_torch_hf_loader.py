"""The port's HF checkpoint loader against ``transformers`` and the JAX loader.

A tiny random BERT is written locally with ``transformers`` (nothing is
downloaded) and loaded through ``modular_rag_system_tpu_torch.models.
hf_loader``, which reads it without ``transformers``.  Held:

* the f32 forward against ``transformers``' mean-pooled output (atol
  2e-5, rtol 1e-4, the JAX test's tolerance) and the WordPiece ids
  against the HF tokenizer's, id for id, native and Python paths;
* the state dict against ``params_from_flax`` of the JAX package's
  ``load_minilm_params``, bit for bit;
* the file paths: the hand-written safetensors parser and writer against
  the ``safetensors`` package, ``pytorch_model.bin``, a hub cache through
  ``HF_HUB_CACHE`` loaded by both packages;
* the config cases: a hidden size other than ``embedding.dim`` falls back
  to the bundled encoder (as in JAX), an explicit checkpoint that cannot
  be read raises (JAX falls back), a position table longer than
  ``max_seq_len`` is cut to it (JAX cannot serve that case);
* the engine: JAX's ``RAGEngine`` and the port's over the same
  checkpoint return equal ids and similarities within 1e-5.

JAX, ``transformers`` and ``safetensors`` are imported inside the tests,
so the ``cuda`` case also runs where they are not installed:

    python -m pytest tests/test_torch_hf_loader.py -m cuda -q --noconftest
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.models import build_encoder
from modular_rag_system_tpu_torch.models import hf_loader as H
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder

ROOT = Path(__file__).resolve().parents[1]

VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    + ["the", "tpu", "compiler", "tiles", "matmul", "onto", "mxu", ".", ","]
    + ["kernel", "fused", "top", "k", "index", "shard", "mesh", "##s", "##ing"]
    + [f"unused{i}" for i in range(23, 64)]
)

TEXTS = [
    "the tpu compiler tiles matmuls onto the mxu .",
    "fused top k kernels , sharding the index",
    "the the the",
    "tilesing fusedes UNKNOWNWORD",
]

_HF_ENV = ("HF_HUB_CACHE", "TRANSFORMERS_CACHE", "HF_HOME")


def _bert_config(max_pos=32, hidden=64):
    return {"architectures": ["BertModel"], "model_type": "bert", "vocab_size": len(VOCAB),
            "hidden_size": hidden, "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 128, "max_position_embeddings": max_pos,
            "hidden_act": "gelu", "hidden_dropout_prob": 0.0,
            "attention_probs_dropout_prob": 0.0, "layer_norm_eps": 1e-12,
            "type_vocab_size": 2, "initializer_range": 0.02}


def _write_tiny_bert(d, max_pos=32, safe=True):
    """A random BertModel saved by ``transformers`` (LayerNorms and biases
    perturbed, so that a swapped weight shows) with its tokenizer."""
    from transformers import BertConfig, BertModel, BertTokenizer

    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    torch.manual_seed(0)
    model = BertModel(BertConfig(**_bert_config(max_pos)))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "LayerNorm" in name:
                p.add_(0.05 * torch.randn(p.shape))
    model.eval()
    model.save_pretrained(d, safe_serialization=safe)
    BertTokenizer(str(d / "vocab.txt"), do_lower_case=True).save_pretrained(d)
    return model


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("tiny_bert")
    return d, _write_tiny_bert(d)


@pytest.fixture()
def no_hf_cache(monkeypatch, tmp_path):
    """No hub cache anywhere: HF_HOME points at an empty directory."""
    for name in _HF_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty_hf_home"))


def _hf_embed(model, ids, mask):
    with torch.no_grad():
        h = model(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
    m = mask.astype(np.float32)[..., None]
    pooled = (h * m).sum(1) / np.maximum(m.sum(1), 1.0)
    return pooled / np.maximum(np.linalg.norm(pooled, axis=-1, keepdims=True), 1e-12)


def _hf_batch(d, texts, max_length):
    from transformers import AutoTokenizer

    b = AutoTokenizer.from_pretrained(d)(texts, padding="max_length", truncation=True,
                                         max_length=max_length, return_tensors="np")
    return b["input_ids"].astype(np.int32), b["attention_mask"].astype(np.int32)


def _config(d, **emb):
    return RAGConfig().merged({"embedding": {"model": "minilm", "dim": 64, "lexical_dim": 0,
                                             "dtype": "float32", "hf_checkpoint": str(d),
                                             **emb}})


def test_forward_matches_transformers(tiny_bert):
    d, model = tiny_bert
    sd, vocab, arch = H.load_minilm_params(local_dir=str(d))
    assert arch == {"num_layers": 2, "hidden": 64, "heads": 4, "mlp_dim": 128,
                    "vocab_size": len(VOCAB), "max_len": 32}
    assert vocab == {p: i for i, p in enumerate(VOCAB)}
    ids, mask = _hf_batch(d, TEXTS, 16)
    assert (mask == 0).any(), "needs real padding"
    enc = MiniLMEncoder(state_dict=sd, dim=64, max_seq_len=32, num_layers=2, num_heads=4,
                        mlp_dim=128, vocab_size=len(VOCAB), dtype="float32", device="cpu")
    ours = enc.forward_tokens(ids, mask).numpy()
    np.testing.assert_allclose(ours, _hf_embed(model, ids, mask), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("use_native", [True, False])
def test_wordpiece_matches_hf_tokenizer(tiny_bert, use_native):
    from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer

    d, _ = tiny_bert
    _, vocab, _ = H.load_minilm_params(local_dir=str(d))
    tok = WordPieceTokenizer(vocab, max_len=16, use_native=use_native)
    assert (tok._wp_native is not None) == use_native
    ids, mask = tok.encode_batch(TEXTS)
    ref_ids, ref_mask = _hf_batch(d, TEXTS, 16)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def test_state_dict_equals_jax_loader(tiny_bert):
    from modular_rag_system_tpu.models.hf_loader import load_minilm_params as jax_load
    from modular_rag_system_tpu_torch.models.default_ckpt import params_from_flax

    d, _ = tiny_bert
    sd, vocab, arch = H.load_minilm_params(local_dir=str(d))
    jparams, jtok, jarch = jax_load(local_dir=str(d))
    ref = params_from_flax(_flatten(jparams))
    assert arch == jarch and vocab == jtok.get_vocab()
    assert sd.keys() == ref.keys()
    for k in ref:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], ref[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_parser_matches_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(3)
    tensors = {"a.weight": torch.randn(7, 5, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "scalar": torch.randn((), generator=g).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    st.save_file(tensors, str(tmp_path / "m.safetensors"), metadata={"format": "pt"})
    ours = H.read_safetensors(tmp_path / "m.safetensors")
    ref = st.load_file(str(tmp_path / "m.safetensors"))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == torch.float32 and ours[k].shape == ref[k].shape
        assert torch.equal(ours[k], ref[k].float()), k
    assert H.read_safetensors(tmp_path / "m.safetensors", names={"b"}).keys() == {"b"}
    # the writer's file, read by the package
    H.write_safetensors(tmp_path / "w.safetensors", tensors)
    back = st.load_file(str(tmp_path / "w.safetensors"))
    for k in tensors:
        assert back[k].dtype == dtype and torch.equal(back[k], tensors[k]), k


def _corrupt(kind, path):
    if kind == "truncated header":
        path.write_bytes((1000).to_bytes(8, "little") + b'{"a":')
    elif kind == "range past the end":
        head = json.dumps({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}})
        path.write_bytes(len(head).to_bytes(8, "little") + head.encode() + b"\0" * 8)
    elif kind == "range of another size":
        head = json.dumps({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}})
        path.write_bytes(len(head).to_bytes(8, "little") + head.encode() + b"\0" * 16)
    else:  # unsupported dtype
        head = json.dumps({"a": {"dtype": "I64", "shape": [2], "data_offsets": [0, 16]}})
        path.write_bytes(len(head).to_bytes(8, "little") + head.encode() + b"\0" * 16)


@pytest.mark.parametrize("kind", ["truncated header", "range past the end",
                                  "range of another size", "unsupported dtype"])
def test_safetensors_parser_refuses_malformed(tmp_path, kind):
    _corrupt(kind, tmp_path / "m.safetensors")
    with pytest.raises(ValueError):
        H.read_safetensors(tmp_path / "m.safetensors")


def test_pytorch_bin_checkpoint(tiny_bert, tmp_path):
    d, _ = tiny_bert
    b = tmp_path / "bin"
    _write_tiny_bert(b, safe=False)
    assert (b / "pytorch_model.bin").is_file() and not (b / "model.safetensors").exists()
    sd_bin, _, _ = H.load_minilm_params(local_dir=str(b))
    sd_st, _, _ = H.load_minilm_params(local_dir=str(d))
    assert all(torch.equal(sd_bin[k], sd_st[k]) for k in sd_st)


def test_prefixed_and_gamma_beta_names(tiny_bert, tmp_path):
    """``BertFor*`` checkpoints prefix ``bert.``; old ones name LayerNorm
    weights ``gamma``/``beta``: both load as ``transformers`` loads them."""
    d, model = tiny_bert
    old = tmp_path / "old"
    old.mkdir()
    for f in ("config.json", "vocab.txt"):
        shutil.copy(d / f, old / f)
    renamed = {"bert." + k.replace("LayerNorm.weight", "LayerNorm.gamma")
               .replace("LayerNorm.bias", "LayerNorm.beta"): v
               for k, v in model.state_dict().items()}
    renamed["cls.predictions.bias"] = torch.zeros(len(VOCAB))
    torch.save(renamed, old / "pytorch_model.bin")
    sd_old, _, _ = H.load_minilm_params(local_dir=str(old))
    sd, _, _ = H.load_minilm_params(local_dir=str(d))
    assert all(torch.equal(sd_old[k], sd[k]) for k in sd)


_JAX_CACHE_SCRIPT = r"""
import json, sys
import numpy as np
from modular_rag_system_tpu.config import RAGConfig
from modular_rag_system_tpu.models import build_encoder
cfg = RAGConfig().merged({"embedding": {"model": "minilm", "dim": 64, "lexical_dim": 0,
                                        "dtype": "float32"}})
enc = build_encoder(cfg)
np.save(sys.argv[1], enc.encode(json.loads(sys.argv[2])))
print(enc.name, enc.tokenizer.name)
"""


def _hub_cache(root, src, sha="0123abcd"):
    model_dir = root / "models--sentence-transformers--all-MiniLM-L6-v2"
    shutil.copytree(src, model_dir / "snapshots" / sha)
    (model_dir / "refs").mkdir(parents=True)
    (model_dir / "refs" / "main").write_text(sha)
    return model_dir


def test_hub_cache_loaded_by_both_packages(tiny_bert, tmp_path, monkeypatch, no_hf_cache):
    d, _ = tiny_bert
    cache = tmp_path / "hub"
    model_dir = _hub_cache(cache, d)
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    assert H._hf_cache_present(H.DEFAULT_MODEL)
    assert H.cache_snapshot(H.DEFAULT_MODEL) == model_dir / "snapshots" / "0123abcd"
    cfg = _config("")
    enc = build_encoder(cfg, device="cpu")
    assert enc.name == "minilm-l2-h64" and enc.tokenizer.name == "wordpiece"
    ours = enc.encode(TEXTS)
    # the hub name also resolves as an explicit checkpoint
    named = build_encoder(_config(H.DEFAULT_MODEL), device="cpu")
    np.testing.assert_array_equal(named.encode(TEXTS), ours)
    # JAX reads the environment when huggingface_hub is imported: its own process
    env = {**os.environ, "HF_HUB_CACHE": str(cache), "HF_HUB_OFFLINE": "1",
           "TRANSFORMERS_OFFLINE": "1", "JAX_PLATFORMS": "cpu", "USE_TF": "0",
           "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _JAX_CACHE_SCRIPT, str(tmp_path / "jax.npy"),
                          json.dumps(TEXTS)], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["minilm-l2-h64", "wordpiece"]
    np.testing.assert_allclose(ours, np.load(tmp_path / "jax.npy"), atol=2e-5, rtol=1e-4)


def test_unreadable_cache_falls_back_to_bundled(tmp_path, monkeypatch, no_hf_cache):
    model_dir = tmp_path / "hub" / "models--sentence-transformers--all-MiniLM-L6-v2"
    (model_dir / "snapshots").mkdir(parents=True)  # no refs/main
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert H._hf_cache_present(H.DEFAULT_MODEL)
    with pytest.raises(FileNotFoundError):
        H.cache_snapshot(H.DEFAULT_MODEL)
    assert H.try_build_pretrained_encoder(RAGConfig(), device="cpu") is None


def test_hidden_mismatch_falls_back_to_bundled(tiny_bert, no_hf_cache):
    from modular_rag_system_tpu.config import RAGConfig as JaxConfig
    from modular_rag_system_tpu.models import build_encoder as jax_build_encoder

    d, _ = tiny_bert
    emb = {"model": "minilm", "dim": 384, "lexical_dim": 0, "hf_checkpoint": str(d)}
    assert H.try_build_pretrained_encoder(RAGConfig().merged({"embedding": emb}),
                                          device="cpu") is None
    enc = build_encoder(RAGConfig().merged({"embedding": emb}), device="cpu")
    jenc = jax_build_encoder(JaxConfig().merged({"embedding": emb}))
    assert enc.dim == jenc.dim == 384 and enc.name == jenc.name
    assert "bundled" in enc.name


@pytest.mark.parametrize("case", ["missing directory", "no weights", "corrupt weights",
                                  "vocab past the table"])
def test_unreadable_explicit_checkpoint_raises(tiny_bert, tmp_path, case, no_hf_cache):
    d, _ = tiny_bert
    bad = tmp_path / "bad"
    if case != "missing directory":
        shutil.copytree(d, bad)
    if case == "no weights":
        (bad / "model.safetensors").unlink()
    elif case == "corrupt weights":
        _corrupt("truncated header", bad / "model.safetensors")
    elif case == "vocab past the table":
        with open(bad / "vocab.txt", "a") as fh:
            fh.write("extra\n")
    with pytest.raises((OSError, ValueError)):
        build_encoder(_config(bad), device="cpu")


def test_long_position_table_is_cut_to_max_seq_len(tmp_path, no_hf_cache):
    """max_position_embeddings 64 served at max_seq_len 32: the table is
    cut to 32 rows and the embeddings equal ``transformers``' at
    truncation 32 (the JAX package builds this encoder but its first
    encode fails on the (64, d) table)."""
    pytest.importorskip("transformers")
    d = tmp_path / "long"
    model = _write_tiny_bert(d, max_pos=64)
    enc = build_encoder(_config(d, max_seq_len=32), device="cpu")
    assert enc.max_seq_len == 32 and enc.module.pos_embed.weight.shape == (32, 64)
    long_text = " ".join(["the tpu compiler tiles"] * 12)
    texts = TEXTS + [long_text]
    ids, mask = _hf_batch(d, texts, 32)
    assert mask[-1].all(), "the long text must fill all 32 positions"
    np.testing.assert_allclose(enc.encode(texts), _hf_embed(model, ids, mask),
                               atol=2e-5, rtol=1e-4)


def _engine_texts():
    rng = np.random.default_rng(5)
    words = VOCAB[5:23] + ["sharding", "meshes", "indexes", "compilers", "unknown"]
    docs = sorted({" ".join(rng.choice(words, rng.integers(4, 12))) for _ in range(80)})
    return docs[:60], [" ".join(rng.choice(words, 5)) for _ in range(6)]


def test_engine_parity_with_jax(tiny_bert, tmp_path, no_hf_cache):
    from modular_rag_system_tpu.config import RAGConfig as JaxConfig
    from modular_rag_system_tpu.engine import RAGEngine as JaxEngine
    from modular_rag_system_tpu.types import Document as JaxDocument
    from modular_rag_system_tpu_torch import create_engine
    from modular_rag_system_tpu_torch.types import Document

    d, _ = tiny_bert
    over = {"embedding.model": "minilm", "embedding.dim": 64, "embedding.lexical_dim": 64,
            "embedding.dtype": "float32", "embedding.max_seq_len": 32,
            "embedding.hf_checkpoint": str(d), "index.tier": "auto",
            "retrieval.time_weight": 0.0, "retrieval.similarity_threshold": 0.0}
    jeng = JaxEngine(JaxConfig.load(overrides={**over, "store.storage_path": str(tmp_path / "j")}))
    peng = create_engine(RAGConfig.load(overrides={**over,
                                                   "store.storage_path": str(tmp_path / "p")}),
                         device="cpu")
    assert peng.encoder.name == jeng.encoder.name
    assert peng.index.dim == jeng.index.dim == 128
    docs, queries = _engine_texts()
    jeng.add_documents([JaxDocument(content=t) for t in docs])
    peng.add_documents([Document(content=t) for t in docs])
    assert peng.index.count == jeng.index.count == len(docs)
    for jres, pres in ((jeng.query_batch(queries, max_results=5),
                        peng.query_batch(queries, max_results=5)),
                       ([jeng.query(queries[0])], [peng.query(queries[0])])):
        for j, p in zip(jres, pres):
            assert [x.id for x in j.documents] == [x.id for x in p.documents]
            np.testing.assert_allclose(j.similarities, p.similarities, rtol=0, atol=1e-5)
    peng.shutdown()
    jeng.shutdown()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from modular_rag_system_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
def test_loader_on_cuda(cuda_device, tmp_path, no_hf_cache):
    """A checkpoint written by hand (no ``transformers``), loaded on the
    card: f32 within 1e-4 of the CPU forward (TF32 off), bf16 within
    cosine 0.995."""
    cfg = _bert_config(max_pos=64)
    d = H.save_hf_checkpoint(tmp_path / "ckpt", H.random_hf_weights(cfg, seed=1), cfg,
                             {p: i for i, p in enumerate(VOCAB)})
    texts = TEXTS * 4
    cpu = build_encoder(_config(d), device="cpu").encode(texts)
    gpu = build_encoder(_config(d), device=cuda_device).encode(texts)
    np.testing.assert_allclose(gpu, cpu, atol=1e-4)
    bf16 = build_encoder(_config(d, dtype="bfloat16"), device=cuda_device).encode(texts)
    assert (bf16 * cpu).sum(1).min() >= 0.995
