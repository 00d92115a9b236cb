"""The plain reference against the port, at a small size on the CPU and
in f32 on both sides: the BERT forward (the bundled checkpoint and a
seeded HF checkpoint read through the port's loader), the tokenizer and
three training steps."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import checks, common, data, engines
from portbench.reference import bert, train, wordpiece

TEXTS = ["How do tides form on the coast?", "Photosynthesis turns light into sugar.",
         "a", "The quick brown fox jumps over the lazy dog " * 8, "naïve café résumé"]


def _port_encoder(overrides):
    from modular_rag_system_tpu_torch.config import RAGConfig
    from modular_rag_system_tpu_torch.models import build_encoder

    cfg = RAGConfig.load(overrides={"embedding.dtype": "float32", **overrides})
    enc = build_encoder(cfg, device="cpu")
    return getattr(enc, "dense", enc)


def _forward_both(dense, w, arch, tok):
    ids, mask = tok.batch(TEXTS)
    got = dense.forward_tokens(ids.astype(np.int32), mask.astype(np.int32))
    want = bert.forward(w, arch, torch.from_numpy(ids), torch.from_numpy(mask))
    return got, want


def test_bundled_forward_matches_the_port():
    cfg = common.config("hybrid-bundled")
    dense = _port_encoder(dict(common.config("hybrid-bundled")["engine"],
                               **{"embedding.dtype": "float32"}))
    got, want = _forward_both(dense, bert.bundled_weights("cpu"), checks.arch_of(cfg),
                              checks.tokenizer(cfg))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_seeded_checkpoint_forward_matches_the_port(tmp_path):
    cfg = common.config("minilm-l6-v2")
    arch = dict(checks.arch_of(cfg), num_layers=2)
    hf = dict(cfg["hf_config"], num_hidden_layers=2)
    w = bert.random_weights(arch, 5, "cpu")
    ckpt = engines.write_hf_checkpoint(tmp_path / "ckpt", hf, data.minilm_vocab(30522), w)
    dense = _port_encoder(dict(cfg["engine"], **{"embedding.hf_checkpoint": str(ckpt),
                                                 "embedding.dtype": "float32"}))
    got, want = _forward_both(dense, w, arch, checks.tokenizer(cfg))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("config", ["hybrid-bundled", "minilm-l6-v2"])
def test_tokenizer_matches_the_port(config):
    from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer

    cfg = common.config(config)
    tok = checks.tokenizer(cfg)
    port = WordPieceTokenizer(tok.vocab, max_len=cfg["served_len"])
    know, questions, passages = data.bundled()
    texts = TEXTS + list(questions[:50]) + list(passages[:50]) + list(know[:50])
    ids, mask = port.encode_batch(texts)
    want_ids, want_mask = tok.batch(texts, width=cfg["served_len"])
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)


def test_three_training_steps_match_the_port():
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    cfg = common.config("hybrid-bundled")
    dense = _port_encoder(dict(cfg["engine"], **{"embedding.dtype": "float32"}))
    trainer = ContrastiveTrainer(dense, learning_rate=1e-5, temperature=0.05,
                                 weight_decay=0.01, clip_norm=1.0)
    batches = [b[:6] for b in list(zip(*[iter(data.pair_pool(3, 3, 12)[0])] * 6))[:3]]
    w0 = bert.bundled_weights("cpu")
    got = [trainer.step([q for q, _ in b], [p for _, p in b])[0] for b in batches]
    tok = wordpiece.WordPiece(checks.tokenizer(cfg).vocab, cfg["max_len"])
    losses, _, w3 = train.run(w0, checks.arch_of(cfg), tok, batches, "cpu", lr=1e-5)
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    names = train.leaf_names(checks.arch_of(cfg))
    for k, v in trainer.params.items():
        torch.testing.assert_close(v.detach(), w3[names[k]], rtol=0, atol=2e-5)
