"""The port's asset-building code against the JAX package's, on the CPU: the
synthetic paraphrase corpus, the harvested training corpus and its pairs,
WordPiece training, the lexical statistics, the encoder asset format (an
asset written by either package loads in the other), the random
initialisation, and the ``build_default_encoder`` tool.

Host code must agree exactly.  Harvesting reads the installed packages,
so it runs here over small roots of this repository (the same roots in
both packages); the tool's own harvest is pointed at them the same way.
Embeddings of one f32 asset through both packages agree within 1e-5.
"""

import dataclasses
import functools
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from modular_rag_system_tpu import RAGConfig as JaxConfig
from modular_rag_system_tpu.models import corpus as jcorpus
from modular_rag_system_tpu.models import default_ckpt as jckpt
from modular_rag_system_tpu.models import lexical as jlex
from modular_rag_system_tpu.models import synth as jsynth
from modular_rag_system_tpu.models import wordpiece_train as jwp
from modular_rag_system_tpu.models.encoder import MiniLMEncoder as JaxEncoder
from modular_rag_system_tpu.models.fake import FeatureHashEncoder as JaxHash
from modular_rag_system_tpu_torch import RAGConfig
from modular_rag_system_tpu_torch.models import corpus as pcorpus
from modular_rag_system_tpu_torch.models import default_ckpt as pckpt
from modular_rag_system_tpu_torch.models import lexical as plex
from modular_rag_system_tpu_torch.models import synth as psynth
from modular_rag_system_tpu_torch.models import wordpiece_train as pwp
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder, random_params
from modular_rag_system_tpu_torch.models.fake import FeatureHashEncoder
from modular_rag_system_tpu_torch.models.tokenizer import load_vocab
from modular_rag_system_tpu_torch.tools import build_default_encoder as ptool

ROOT = Path(__file__).resolve().parents[1]
# small harvest roots: prose (docs/) and docstrings (the JAX package)
ROOTS = (str(ROOT / "docs"), str(ROOT / "modular_rag_system_tpu"))
TEXTS = ["Glaciers carve U-shaped valleys as they move downhill.",
         "a large automobile", "The red planet has two small moons.", ""]


@pytest.fixture(scope="module")
def sentences():
    return pcorpus.harvest_container_text(max_sentences=5_000, max_py_files=200,
                                          roots=ROOTS)


@pytest.mark.parametrize("kw", [{}, {"hardness": 0.6, "seed": 3},
                                {"facts_per_doc": 3, "n_entities": 12, "n_relations": 7}])
def test_paraphrase_corpus_equal(kw):
    j, p = jsynth.make_paraphrase_corpus(**kw), psynth.make_paraphrase_corpus(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert jsynth.recall_at_k(JaxHash(dim=128), j, 5) == psynth.recall_at_k(
        FeatureHashEncoder(dim=128), p, 5)


def test_harvest_and_pairs_equal(sentences):
    kw = dict(max_sentences=5_000, max_py_files=200, roots=ROOTS)
    assert jcorpus.harvest_container_text(**kw) == sentences
    assert len(sentences) > 100
    assert jcorpus.load_knowledge() == pcorpus.load_knowledge()
    assert jcorpus.load_train_qa() == pcorpus.load_train_qa()
    assert jcorpus.synonym_table() == pcorpus.synonym_table()
    for make in ("make_pairs", "make_question_pairs"):
        assert getattr(jcorpus, make)(sentences, 300, seed=4) == getattr(pcorpus, make)(
            sentences, 300, seed=4), make
    know = pcorpus.load_knowledge()[:200]
    ja = [jcorpus.alias_substitute(t, random.Random(2)) for t in know]
    assert ja == [pcorpus.alias_substitute(t, random.Random(2)) for t in know]


def test_wordpiece_training_equal(sentences, tmp_path):
    text = sentences + pcorpus.load_knowledge()
    vocab = pwp.train_wordpiece(text, vocab_size=1_500)
    assert vocab == jwp.train_wordpiece(text, vocab_size=1_500)
    assert len(vocab) == 1_500
    pwp.save_vocab(vocab, str(tmp_path / "p.txt"))
    jwp.save_vocab(vocab, str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert load_vocab(str(tmp_path / "p.txt")) == vocab


def test_lexical_tables_equal(sentences, tmp_path):
    texts = sentences + pcorpus.load_knowledge()
    jidf, pidf = jlex.IdfTable.from_texts(texts), plex.IdfTable.from_texts(texts)
    assert (pidf.idf, pidf.default) == (jidf.idf, jidf.default)
    jexp, pexp = jlex.ExpansionTable.from_texts(texts), plex.ExpansionTable.from_texts(texts)
    assert pexp.table == jexp.table and len(pexp.table) > 100
    for tab, name in ((jidf, "j_idf"), (pidf, "p_idf"), (jexp, "j_exp"), (pexp, "p_exp")):
        tab.save(str(tmp_path / f"{name}.json"))
    for kind in ("idf", "exp"):
        assert (tmp_path / f"p_{kind}.json").read_bytes() == (
            tmp_path / f"j_{kind}.json").read_bytes()
    # a lexical encoder over the rebuilt tables: the same vectors
    je = jlex.LexicalHashEncoder(dim=128, idf=jidf, expansion=jexp)
    pe = plex.LexicalHashEncoder(dim=128, idf=pidf, expansion=pexp)
    np.testing.assert_array_equal(pe.encode(TEXTS), je.encode(TEXTS))


def test_build_lexical_statistics_equal(tmp_path, monkeypatch):
    for mod in (jcorpus, pcorpus):
        monkeypatch.setattr(mod, "harvest_container_text", functools.partial(
            mod.harvest_container_text, roots=ROOTS))
    js = jlex.build_lexical_statistics(out_dir=str(tmp_path / "j"), max_sentences=5_000,
                                       max_py_files=200)
    ps = plex.build_lexical_statistics(tmp_path / "p", max_sentences=5_000, max_py_files=200)
    assert {k: v for k, v in ps.items() if k != "asset_dir"} == {
        k: v for k, v in js.items() if k != "asset_dir"}
    for name in ("idf.json", "expansion.json"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    # the port never writes the JAX package's assets, and names its target
    with pytest.raises(ValueError, match="assets"):
        plex.build_lexical_statistics(pckpt.ASSET_DIR)
    with pytest.raises(TypeError):
        plex.build_lexical_statistics()


ARCH = dict(num_layers=2, hidden=64, heads=4, mlp_dim=128, max_len=32)


def _vocab(sentences):
    return pwp.train_wordpiece(sentences, vocab_size=800)


def _encoders(asset_dir):
    """The asset through both packages' loaders, f32, dense only."""
    over = {"embedding.bundled_checkpoint": str(asset_dir), "embedding.dim": ARCH["hidden"],
            "embedding.dtype": "float32", "embedding.lexical_dim": 0,
            "embedding.max_seq_len": ARCH["max_len"]}
    je = jckpt.try_build_default_encoder(JaxConfig.load(overrides=over))
    pe = pckpt.build_default_encoder(RAGConfig.load(overrides=over), device="cpu")
    assert je is not None and je.name == pe.name
    return je, pe


def test_port_asset_loads_in_jax(sentences, tmp_path):
    vocab = _vocab(sentences)
    arch = {**ARCH, "vocab_size": len(vocab)}
    enc = MiniLMEncoder(dim=64, max_seq_len=32, num_layers=2, num_heads=4, mlp_dim=128,
                        vocab_size=len(vocab), dtype="float32", device="cpu", seed=5)
    pckpt.save_default_encoder(enc.params, arch, vocab, tmp_path / "a")
    je, pe = _encoders(tmp_path / "a")
    np.testing.assert_allclose(pe.encode(TEXTS), je.encode(TEXTS), rtol=0, atol=1e-5)
    # the asset holds the weights rounded to f16, in flax's layout
    flat, _, _ = pckpt.load_default_assets(str(tmp_path / "a"))
    for k, v in pckpt.params_to_flax(enc.params, ARCH["heads"]).items():
        np.testing.assert_array_equal(flat[k], v.astype(np.float16).astype(np.float32))
    with pytest.raises(ValueError, match="assets"):
        pckpt.save_default_encoder(enc.params, arch, vocab, pckpt.ASSET_DIR)


def test_jax_asset_loads_in_port(sentences, tmp_path):
    vocab = _vocab(sentences)
    arch = {**ARCH, "vocab_size": len(vocab)}
    enc = JaxEncoder(dim=64, max_seq_len=32, num_layers=2, num_heads=4, mlp_dim=128,
                     vocab_size=len(vocab), dtype="float32", seed=5)
    import jax

    jckpt.save_default_encoder(jax.tree.map(np.asarray, enc.params), arch, vocab,
                               str(tmp_path / "a"))
    je, pe = _encoders(tmp_path / "a")
    np.testing.assert_allclose(pe.encode(TEXTS), je.encode(TEXTS), rtol=0, atol=1e-5)
    # and back: the port's state dict maps onto the same flax tree
    flat, _, _ = pckpt.load_default_assets(str(tmp_path / "a"))
    back = pckpt.params_to_flax(pckpt.params_from_flax(flat), ARCH["heads"])
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_random_init_statistics_match_flax():
    kw = dict(dim=64, max_seq_len=32, num_layers=2, num_heads=4, mlp_dim=256,
              vocab_size=1000, dtype="float32")
    jflat = jckpt._flatten(JaxEncoder(**kw, seed=0).params)
    enc = MiniLMEncoder(**kw, device="cpu", seed=0)
    pflat = pckpt.params_to_flax(enc.params, 4)
    assert set(pflat) == set(jflat)
    for k, jv in jflat.items():
        pv = pflat[k]
        assert pv.shape == jv.shape, k
        if jv.std() == 0:  # biases, LayerNorm scale and bias: constants
            np.testing.assert_array_equal(pv, jv, err_msg=k)
            continue
        assert abs(pv.std() - jv.std()) <= 0.1 * jv.std(), (k, pv.std(), jv.std())
        assert abs(pv.mean()) <= 0.1 * jv.std(), k
        # lecun-normal kernels are truncated at two raw standard deviations
        assert np.abs(pv).max() <= 1.1 * np.abs(jv).max(), k
    # the seed decides the weights; the encoder keeps them as f32 params
    again = MiniLMEncoder(**kw, device="cpu", seed=0).params
    other = MiniLMEncoder(**kw, device="cpu", seed=1).params
    assert all(torch.equal(again[k], v) for k, v in enc.params.items())
    assert not torch.equal(other["tok_embed.weight"], enc.params["tok_embed.weight"])
    assert all(v.dtype == torch.float32 for v in enc.params.values())
    assert len(random_params(enc.module)) == len(enc.params)


def test_random_init_when_bundled_checkpoint_disabled():
    from modular_rag_system_tpu_torch.models import build_encoder

    over = {"embedding.bundled_checkpoint": "", "embedding.dim": 64,
            "embedding.num_layers": 1, "embedding.num_heads": 4, "embedding.mlp_dim": 128,
            "embedding.vocab_size": 1000, "embedding.max_seq_len": 32,
            "embedding.lexical_dim": 32, "embedding.dtype": "float32"}
    enc = build_encoder(RAGConfig.load(overrides=over), device="cpu")
    assert enc.dim == 96 and enc.dense.name == "minilm-l1-h64"
    e = enc.encode(TEXTS)
    assert e.shape == (len(TEXTS), 96) and np.isfinite(e).all()


def test_build_default_encoder_tool_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(pcorpus, "harvest_container_text", functools.partial(
        pcorpus.harvest_container_text, roots=ROOTS))
    out = tmp_path / "asset"
    assert ptool.main(["--smoke", "--steps", "2", "--batch", "8", "--layers", "1",
                       "--device", "cpu", "--out", str(out)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["assets"] == str(out) and result["steps"] == 2
    assert 0.3 <= result["tuned_lexical_weight"] <= 0.8
    assert sorted(p.name for p in out.iterdir()) == [
        "arch.json", "expansion.json", "idf.json", "params.npz", "vocab.txt"]
    arch = json.loads((out / "arch.json").read_text())
    assert arch == {"num_layers": 1, "hidden": 384, "heads": 12, "mlp_dim": 1536,
                    "vocab_size": 2048, "max_len": 48}
    # the asset serves through the port's loader, and loads in JAX
    over = {"embedding.bundled_checkpoint": str(out), "embedding.dtype": "float32",
            "embedding.lexical_dim": 0}
    enc = pckpt.build_default_encoder(RAGConfig.load(overrides=over), device="cpu")
    e = enc.encode(TEXTS)
    np.testing.assert_allclose(np.linalg.norm(e[:3], axis=1), 1.0, atol=1e-5)
    assert jckpt.try_build_default_encoder(JaxConfig.load(overrides=over)) is not None
    # --out is required, and may not name the JAX package's assets
    with pytest.raises(SystemExit):
        ptool.main(["--smoke"])
    with pytest.raises(ValueError, match="assets"):
        ptool.main(["--smoke", "--device", "cpu", "--out", str(pckpt.ASSET_DIR)])
