"""Port encoder stack vs the JAX package's, on the CPU.

Tokenizers and the lexical encoder are host code and must agree exactly.
The dense forward runs the bundled weights through both packages from
the same flat parameter dict: at float32 the two agree to 1e-5 (they
differ only in summation order), at bfloat16 the rounding points of the
two frameworks differ, so the bar is cosine >= 0.999 per row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_rag_system_tpu.config import RAGConfig as JaxConfig
from modular_rag_system_tpu.models import build_encoder as jax_build_encoder
from modular_rag_system_tpu.models import lexical as jlex
from modular_rag_system_tpu.models import tokenizer as jtok
from modular_rag_system_tpu.models.default_ckpt import _unflatten
from modular_rag_system_tpu.models.encoder import SentenceEncoderModule as JaxModule
from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.models import build_encoder
from modular_rag_system_tpu_torch.models import lexical as plex
from modular_rag_system_tpu_torch.models import tokenizer as ptok
from modular_rag_system_tpu_torch.models.default_ckpt import (
    load_default_assets,
    params_from_flax,
)
from modular_rag_system_tpu_torch.models.encoder import SentenceEncoderModule

TEXTS = [
    "Hurricanes draw their energy from warm ocean water.",
    "a large automobile",
    "The mitochondria is the powerhouse of the cell!!! (really)",
    "Café au lait — naïve façade, 東京 and Zürich",
    "x" * 150 + " supercalifragilisticexpialidocious 12345",
    "",
]


@pytest.fixture(scope="module")
def assets():
    return load_default_assets()


def test_wordpiece_tokenizer_parity(assets):
    _, arch, vocab = assets
    jt = jtok.WordPieceTokenizer(vocab, max_len=arch["max_len"])
    pt = ptok.WordPieceTokenizer(vocab, max_len=arch["max_len"])
    for batch in (TEXTS[:3], TEXTS):  # ASCII-only (native path in JAX) and mixed
        ji, jm = jt.encode_batch(batch)
        pi, pm = pt.encode_batch(batch)
        np.testing.assert_array_equal(ji, pi)
        np.testing.assert_array_equal(jm, pm)
    assert [jt.token_count(t) for t in TEXTS] == [pt.token_count(t) for t in TEXTS]


def test_hashing_tokenizer_parity():
    jt = jtok.HashingTokenizer(vocab_size=16384, max_len=64)
    pt = ptok.HashingTokenizer(vocab_size=16384, max_len=64)
    ji, jm = jt.encode_batch(TEXTS)
    pi, pm = pt.encode_batch(TEXTS)
    np.testing.assert_array_equal(ji, pi)
    np.testing.assert_array_equal(jm, pm)
    assert [jt.token_count(t) for t in TEXTS] == [pt.token_count(t) for t in TEXTS]


def test_lexical_hash_encoder_exact():
    je = jlex.LexicalHashEncoder(dim=384)
    pe = plex.LexicalHashEncoder(dim=384)
    np.testing.assert_array_equal(je.encode(TEXTS), pe.encode(TEXTS))


def _forward_both(assets, dtype):
    flat, arch, vocab = assets
    kw = dict(vocab_size=arch["vocab_size"], hidden=arch["hidden"],
              layers=arch["num_layers"], heads=arch["heads"],
              mlp_dim=arch["mlp_dim"], max_len=arch["max_len"])
    ids, mask = ptok.WordPieceTokenizer(vocab, max_len=32).encode_batch(TEXTS)
    jm = JaxModule(dtype=getattr(jnp, dtype), **kw)
    ref = jm.apply({"params": _unflatten(flat)}, jnp.asarray(ids), jnp.asarray(mask))
    pm = SentenceEncoderModule(dtype=getattr(torch, dtype), **kw)
    pm.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        out = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    return np.asarray(ref), out.numpy()


def test_params_from_flax_covers_checkpoint(assets):
    flat, arch, _ = assets
    sd = params_from_flax(flat)
    pm = SentenceEncoderModule(vocab_size=arch["vocab_size"], hidden=arch["hidden"],
                               layers=arch["num_layers"], heads=arch["heads"],
                               mlp_dim=arch["mlp_dim"], max_len=arch["max_len"])
    assert set(sd) == set(pm.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(v.size for v in flat.values())


def test_forward_float32_matches_flax(assets):
    ref, out = _forward_both(assets, "float32")
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_forward_bfloat16_matches_flax(assets):
    ref, out = _forward_both(assets, "bfloat16")
    cos = np.sum(ref * out, axis=1) / (
        np.linalg.norm(ref, axis=1) * np.linalg.norm(out, axis=1))
    assert cos.min() >= 0.999, cos


@pytest.fixture(scope="module")
def hybrid_pair():
    over = {"embedding.dtype": "float32", "embedding.batch_size": 4}
    return (jax_build_encoder(JaxConfig.load(overrides=over)),
            build_encoder(RAGConfig.load(overrides=over), device="cpu"))


def test_hybrid_encode_device_parity(hybrid_pair):
    je, pe = hybrid_pair
    assert pe.name == je.name and pe.dim == je.dim == 768
    ref = np.asarray(jax.block_until_ready(je.encode_device(TEXTS)))
    out = pe.encode_device(TEXTS)
    assert out.dtype == torch.float32 and out.shape == (len(TEXTS), 768)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # the host path re-normalizes the dense half: same result here
    np.testing.assert_allclose(pe.encode(TEXTS), je.encode(TEXTS), rtol=0, atol=1e-5)


def test_build_encoder_raises_on_broken_checkpoint(tmp_path):
    cfg = RAGConfig.load(overrides={"embedding.bundled_checkpoint": str(tmp_path)})
    with pytest.raises(FileNotFoundError):
        build_encoder(cfg, device="cpu")
    with pytest.raises(ValueError):
        build_encoder(RAGConfig.load(overrides={"embedding.dim": 64}), device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        build_encoder(RAGConfig.load(overrides={"embedding.attention_impl": "Flash"}),
                      device="cpu")
