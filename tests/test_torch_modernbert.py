"""ModernBERT on the port's encoder path, on the CPU at a small size.

A seeded ModernBERT (4 layers: a whole period of global, local, local and
the next global layer; hidden 64, 4 heads, GeGLU FFN 96, a window of
|i - j| <= 8, vocab 512) is written as a local HF checkpoint, loaded
through ``hf_loader`` and held against ``portbench/reference/
modernbert.py``, whose equations are held against transformers'
``ModernBertModel``.  Weights at the configuration's std 0.02 and at
0.2, whose attention is far from uniform, so that a wrong RoPE base or
band shows.  Tolerances and their reasons:

* port against the reference, f32 on both sides: the same operations in
  another summation order (einsum and matmul, the softmax against exp and
  sum): each component of a unit row within 1e-6;
* the reference against ``ModernBertModel`` (eager attention), f32: the
  same operations in the same order, within 1e-6;
* the window mode's plain version against a dense softmax with the band
  and key masks: f32 within 1e-6 of the output's scale; bf16 rounds each
  probability before it multiplies v (2^-9 of max |v| at most) and the
  output (2^-9 of it), so |d| <= 2^-8 (max|v| + |ref|) + 1e-6;
* the engine: a stored row equals the reference's embedding within
  1e-6, and a document's own text retrieves it first.
"""

import json
import math

import numpy as np
import pytest
import torch

from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.models import build_encoder
from modular_rag_system_tpu_torch.models import hf_loader as H
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder, SentenceEncoderModule
from modular_rag_system_tpu_torch.models.modernbert import ModernBertModule, band_pairs
from modular_rag_system_tpu_torch.ops.flash_attention import (
    mea_attention,
    mea_attention_reference,
)
from modular_rag_system_tpu_torch.utils.profiling import TRACER
from portbench.reference import modernbert as ref
from portbench.reference.wordpiece import WordPiece, load_vocab

from modular_rag_system_tpu_torch.models.default_ckpt import ASSET_DIR

CFG = {"architectures": ["ModernBertModel"], "model_type": "modernbert", "vocab_size": 512,
       "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4,
       "intermediate_size": 96, "max_position_embeddings": 256,
       "global_attn_every_n_layers": 3, "local_attention": 16,
       "global_rope_theta": 160000.0, "local_rope_theta": 10000.0, "norm_eps": 1e-5,
       "norm_bias": False, "attention_bias": False, "mlp_bias": False,
       "hidden_activation": "gelu", "pad_token_id": 0}
WINDOW = CFG["local_attention"] // 2
# 6, 18, 24, 71 and 3 tokens: from below the band's 17 keys to four bands
TEXTS = ["the cell", "energy from the ocean water and the wind",
         "the mitochondria is the powerhouse of the cell",
         "hurricanes draw their energy from warm ocean water , and the storms grow " * 2,
         "a"]


def _vocab():
    full = load_vocab(ASSET_DIR / "vocab.txt")
    return {p: i for p, i in full.items() if i < CFG["vocab_size"]}


def _weights(seed=3, std=0.02):
    return ref.random_weights(CFG, seed, "cpu", std)


def _write(d, weights, cfg=CFG, vocab=True):
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(cfg))
    if vocab:
        v = _vocab()
        (d / "vocab.txt").write_text("".join(p + "\n" for p, _ in
                                             sorted(v.items(), key=lambda kv: kv[1])))
    H.write_safetensors(d / "model.safetensors", weights)
    return d


def _encoder(ckpt, impl="dense", max_seq_len=128, batch_size=8):
    cfg = RAGConfig.load(overrides={
        "embedding.hf_checkpoint": str(ckpt), "embedding.dim": CFG["hidden_size"],
        "embedding.lexical_dim": 0, "embedding.max_seq_len": max_seq_len,
        "embedding.attention_impl": impl, "embedding.dtype": "float32",
        "embedding.batch_size": batch_size})
    return build_encoder(cfg, device="cpu")


def _want(weights, texts):
    return ref.embed(weights, CFG, WordPiece(_vocab(), 256), texts, "cpu")


def _masked_lm(weights):
    """The same weights as ``ModernBertForMaskedLM`` names them."""
    out = {"model." + k: v for k, v in weights.items()}
    h = CFG["hidden_size"]
    out.update({"head.dense.weight": torch.zeros(h, h), "head.norm.weight": torch.ones(h),
                "decoder.bias": torch.zeros(CFG["vocab_size"])})
    return out


# ---------------------------------------------------------------------------
# the reference's equations
def test_reference_matches_transformers_modernbert():
    from transformers import ModernBertConfig, ModernBertModel

    w = _weights()
    hf = ModernBertModel(ModernBertConfig(**CFG, attn_implementation="eager",
                                          reference_compile=False)).eval()
    missing, unexpected = hf.load_state_dict(w, strict=False)
    assert not missing and not unexpected
    g = torch.Generator().manual_seed(0)
    for L in (5, 40, 77):
        ids = torch.randint(5, CFG["vocab_size"], (1, L), generator=g)
        with torch.no_grad():
            out = hf(input_ids=ids, attention_mask=torch.ones_like(ids)).last_hidden_state[0]
        pooled = out.mean(0) / out.mean(0).norm()
        got = ref.forward(w, CFG, ids[0], block=16)
        assert (got - pooled).abs().max().item() <= 1e-6


# ---------------------------------------------------------------------------
# the window mode of mea_attention
def _dense_band(q, k, v, pad, w):
    B, L, H, dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(dh)
    pos = torch.arange(L)
    keep = (pad.bool()[:, None, None, :]
            & ((pos[:, None] - pos[None, :]).abs() <= w)[None, None])
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # a row with no key: zeros
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,w", [(5, 8), (20, 0), (20, 3), (130, 8), (300, 64), (40, 500)])
def test_window_reference_matches_dense_softmax(dtype, L, w):
    g = torch.Generator().manual_seed(L + w)
    B, H, dh = 3, 2, 16
    q, k, v = (torch.randn((B, L, H, dh), generator=g).to(dtype) for _ in range(3))
    pad = torch.ones((B, L), dtype=torch.int32)
    pad[0, L * 5 // 8:] = 0
    pad[-1] = 0
    got = mea_attention_reference(q, k, v, pad, window=w).double()
    want = _dense_band(q, k, v, pad, w)
    assert torch.equal(mea_attention(q, k, v, pad, window=w).double(), got)
    if dtype == torch.float32:
        tol = 1e-6 * (1.0 + want.abs())
    else:
        vmax = v.double().abs().amax(dim=1, keepdim=True)  # per batch row, head, column
        tol = 2.0**-8 * (vmax + want.abs()) + 1e-6
    assert ((got - want).abs() <= tol).all()
    # rows whose band holds no live key are zeros
    assert (got[-1] == 0).all()
    assert (got[0, L * 5 // 8 + w:] == 0).all()


def test_window_refuses_a_negative_width():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError):
        mea_attention(q, q, q, torch.ones((1, 4)), window=-1)


def test_band_pairs():
    for L in (1, 2, 7, 40):
        for w in (0, 1, 3, 8, 100):
            want = sum(1 for i in range(L) for j in range(L) if abs(i - j) <= w)
            assert band_pairs(L, w) == want


# ---------------------------------------------------------------------------
# the port's module through hf_loader
@pytest.mark.parametrize("std", [0.02, 0.2])
@pytest.mark.parametrize("names", ["model", "masked_lm"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_port_matches_reference(tmp_path, impl, names, std):
    w = _weights(std=std)
    enc = _encoder(_write(tmp_path / "ck", w if names == "model" else _masked_lm(w)), impl)
    assert isinstance(enc, MiniLMEncoder) and isinstance(enc.module, ModernBertModule)
    assert enc.model_type == "modernbert" and enc.name == "modernbert-l4-h64"
    want = _want(w, TEXTS)
    # the wrapper: bucketed, the batch padded to 8 rows
    got = enc.encode_device(TEXTS)
    assert (got - want).abs().max().item() <= 1e-6
    # the module at exact widths: below the window, a few windows
    tok = WordPiece(_vocab(), 256)
    for texts in (TEXTS[:2], TEXTS[:3], TEXTS[:4]):
        ids, mask = tok.batch(texts)
        got = enc.forward_tokens(ids, mask)
        assert (got - _want(w, texts)).abs().max().item() <= 1e-6


def test_layer_zero_has_no_attn_norm(tmp_path):
    w = _weights()
    assert "layers.0.attn_norm.weight" not in w
    sd, _, arch = H.load_checkpoint(local_dir=str(_write(tmp_path / "ck", w)))
    assert arch["model_type"] == "modernbert" and "blocks.0.attn_norm.weight" not in sd
    assert "blocks.1.attn_norm.weight" in sd and "blocks.3.attn_norm.weight" in sd
    assert arch["layout"] == {"global_every": 3, "window": WINDOW, "global_theta": 160000.0,
                              "local_theta": 10000.0, "eps": 1e-5}
    enc = _encoder(tmp_path / "ck")
    kinds = [(b.is_global, b.attn.window, b.attn_norm is None) for b in enc.module.blocks]
    assert kinds == [(True, None, True), (False, WINDOW, False), (False, WINDOW, False),
                     (True, None, False)]


def test_rope_bases_and_window_matter(tmp_path):
    # a checkpoint read with another window or another local base embeds
    # otherwise: the layout reaches the layers (weights at std 0.2, whose
    # attention is far from uniform)
    w = _weights(std=0.2)
    base = _encoder(_write(tmp_path / "a", w)).encode_device(TEXTS[3:4])
    for change in ({"local_attention": 12}, {"local_rope_theta": 160000.0},
                   {"global_rope_theta": 10000.0}):
        other = _encoder(_write(tmp_path / "b", w, dict(CFG, **change))).encode_device(TEXTS[3:4])
        assert (other - base).abs().max().item() > 1e-3, change


@pytest.mark.parametrize("change,err", [({"norm_bias": True}, ValueError),
                                        ({"mlp_bias": True}, ValueError),
                                        ({"hidden_activation": "silu"}, ValueError)])
def test_loader_refuses_what_it_does_not_compute(tmp_path, change, err):
    with pytest.raises(err):
        H.load_checkpoint(local_dir=str(_write(tmp_path / "ck", _weights(),
                                               dict(CFG, **change))))


def test_loader_needs_a_wordpiece_vocab(tmp_path):
    d = _write(tmp_path / "ck", _weights(), vocab=False)
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        _encoder(d)


def test_a_bert_checkpoint_still_loads_as_bert(tmp_path):
    cfg = {"architectures": ["BertModel"], "model_type": "bert", "vocab_size": 512,
           "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
           "intermediate_size": 128, "max_position_embeddings": 64, "hidden_act": "gelu",
           "layer_norm_eps": 1e-12, "type_vocab_size": 2, "initializer_range": 0.02}
    d = H.save_hf_checkpoint(tmp_path / "bert", H.random_hf_weights(cfg, 1), cfg, _vocab())
    sd, vocab, arch = H.load_checkpoint(local_dir=str(d))
    sd0, vocab0, arch0 = H.load_minilm_params(local_dir=str(d))
    assert arch == dict(arch0, model_type="bert") and vocab == vocab0
    assert all(torch.equal(sd[k], sd0[k]) for k in sd0) and set(sd) == set(sd0)
    enc = _encoder(d)
    assert enc.model_type == "bert" and type(enc.module) is SentenceEncoderModule
    assert enc.name == "minilm-l2-h64"


def test_trainer_refuses_modernbert(tmp_path):
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    enc = _encoder(_write(tmp_path / "ck", _weights()))
    with pytest.raises(ValueError, match="BERT-class"):
        ContrastiveTrainer(enc)


# ---------------------------------------------------------------------------
# spans and counters
def test_attention_spans_and_counters(tmp_path):
    enc = _encoder(_write(tmp_path / "ck", _weights()), "flash")
    TRACER.reset()
    TRACER.enable()
    try:
        enc.encode_device(TEXTS)
        counts, totals = TRACER.counters(), TRACER.totals()
    finally:
        TRACER.disable()
        TRACER.reset()
    B, L, heads = 8, 128, CFG["num_attention_heads"]  # 5 texts padded to 8 rows, bucket 128
    assert counts["encoder.padded_tokens"] == B * L
    assert counts["encoder.attn_global_pairs"] == 2 * B * heads * L * L
    assert counts["encoder.attn_local_pairs"] == 2 * B * heads * band_pairs(L, WINDOW)
    assert counts["encoder.attn_global_rows"] == 2 * B * heads * L
    assert counts["encoder.attn_local_rows"] == 2 * B * heads * L
    assert totals["encoder.attn_global"][1] == totals["encoder.attn_local"][1] == 2


# ---------------------------------------------------------------------------
# the engine on a tiny ModernBERT checkpoint
def test_engine_adds_and_answers(tmp_path):
    from modular_rag_system_tpu_torch.engine import RAGEngine
    from modular_rag_system_tpu_torch.types import Document

    w = _weights()
    cfg = RAGConfig.load(overrides={
        "embedding.hf_checkpoint": str(_write(tmp_path / "ck", w)),
        "embedding.dim": CFG["hidden_size"], "embedding.lexical_dim": 0,
        "embedding.max_seq_len": 128, "embedding.attention_impl": "flash",
        "embedding.dtype": "float32", "index.tier": "exact",
        "store.storage_path": str(tmp_path / "store"), "store.snapshot_on_shutdown": False,
        "retrieval.similarity_threshold": 0.0, "retrieval.time_weight": 0.0,
        "serving.file_server_port": 0})
    eng = RAGEngine(cfg, device="cpu")
    try:
        ids = eng.add_documents([Document(content=t, source="notes") for t in TEXTS])
        assert eng.index.count == len(TEXTS)
        want = _want(w, TEXTS)
        for i, doc_id in enumerate(ids):
            row = eng.store.row_of(doc_id)
            assert (eng.index.E[row].float() - want[i]).abs().max().item() <= 1e-6
        q = eng.encoder.encode_device([TEXTS[3]])
        assert (q[0] - want[3]).abs().max().item() <= 1e-6
        res = eng.query(TEXTS[3], max_results=2)
        assert res.documents[0].content == TEXTS[3]
    finally:
        eng.shutdown()
