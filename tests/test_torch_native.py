"""The port's native text engine against the JAX package's and the Python path.

Both tokenizers (hashing and WordPiece, under the bundled 16,384-piece
vocab and a 30,522-piece BERT-sized one) must give the same ids, masks
and token counts through the port's native engine, the JAX package's
native engine and the port's Python path: id for id, on ASCII text,
non-ASCII text (which takes the Python path, row by row in a mixed
batch), control whitespace,
truncation and empty strings, and from 4 threads at once.  The build is
checked for concurrent first builds (a temporary name renamed into
place) and for a failure that is logged with the compiler's output.

JAX is imported inside the tests, so the ``cuda`` case (the engine built
and its ids checked on the card's machine) also runs without it:

    python -m pytest tests/test_torch_native.py -m cuda -q --noconftest
"""

import ctypes
import logging
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from modular_rag_system_tpu_torch import native
from modular_rag_system_tpu_torch.models import tokenizer as ptok
from modular_rag_system_tpu_torch.models.default_ckpt import ASSET_DIR

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "internationalization and localization are long words",
    "short",
    "punctuation, numbers 12345 and symbols #!? mixed in [CLS] [unused3]",
    "a " * 300,  # past max_len: truncated
    "",
    "tabs\tnew\nlines\rvertical\x0bfeed\x0cfile\x1cgroup\x1drecord\x1eunit\x1fend",
    "NUL\x00 and DEL\x7f and bell\x07 are pieces, not spaces",
    "x" * 150 + " supercalifragilisticexpialidocious unaffable ##ing",
    "Hurricanes draw their energy from warm ocean water.",
]
NON_ASCII = ["Café au lait — naïve façade, 東京 and Zürich", "plain ascii beside it"]


def _bundled_vocab():
    return ptok.load_vocab(str(ASSET_DIR / "vocab.txt"))


def _bert_sized_vocab():
    """The bundled pieces padded with ``[unusedN]`` to 30,522 ids (the
    vocab ``chip_smoke.py`` writes with its all-MiniLM-L6-v2-wide
    checkpoint)."""
    vocab = dict(_bundled_vocab())
    n = len(vocab)
    vocab.update({f"[unused{i}]": n + i for i in range(30522 - n)})
    return vocab


VOCABS = {"bundled": _bundled_vocab, "bert_sized": _bert_sized_vocab}


@pytest.fixture(scope="module")
def engine():
    eng = native.get_engine()
    assert eng is not None, "the native engine did not build (g++ is required)"
    return eng


def test_engine_builds_under_its_source_hash(engine):
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libtextengine-") and path.suffix == ".so"
    assert ptok.HashingTokenizer()._native is engine


def _hashing(use_native, jax=False, **kw):
    if jax:
        from modular_rag_system_tpu.models import tokenizer as jtok

        return jtok.HashingTokenizer(use_native=use_native, **kw)
    return ptok.HashingTokenizer(use_native=use_native, **kw)


def _wordpiece(vocab, use_native, jax=False, max_len=64):
    if jax:
        from modular_rag_system_tpu.models import tokenizer as jtok

        return jtok.WordPieceTokenizer(vocab, max_len=max_len, use_native=use_native)
    return ptok.WordPieceTokenizer(vocab, max_len=max_len, use_native=use_native)


def _assert_same(toks, texts):
    ref_ids, ref_mask = toks[0].encode_batch(texts)
    for tok in toks[1:]:
        ids, mask = tok.encode_batch(texts)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(mask, ref_mask)
    for t in texts:
        assert len({tok.token_count(t) for tok in toks}) == 1, t


@pytest.mark.parametrize("kw", [dict(vocab_size=30522, max_len=64),
                                dict(vocab_size=16384, max_len=128),
                                dict(vocab_size=512, max_len=32, piece_len=4)],
                         ids=["30522", "16384", "512-piece4"])
def test_hashing_parity(engine, kw):
    from modular_rag_system_tpu.native import get_engine as jax_get_engine

    port_native = _hashing(True, **kw)
    assert port_native._native is engine
    toks = [_hashing(False, **kw), port_native]
    if jax_get_engine() is not None:
        toks.append(_hashing(True, jax=True, **kw))
    _assert_same(toks, [t for t in TEXTS if t])
    _assert_same(toks, TEXTS)
    _assert_same(toks, NON_ASCII)  # the Python path, in every tokenizer


@pytest.mark.parametrize("vocab_name", list(VOCABS))
def test_wordpiece_parity(engine, vocab_name):
    from modular_rag_system_tpu.native import get_engine as jax_get_engine

    vocab = VOCABS[vocab_name]()
    port_native = _wordpiece(vocab, True)
    assert port_native._wp_native is not None
    toks = [_wordpiece(vocab, False), port_native, _wordpiece(vocab, False, jax=True)]
    if jax_get_engine() is not None:
        toks.append(_wordpiece(vocab, True, jax=True))
    _assert_same(toks, TEXTS)
    _assert_same(toks, NON_ASCII)


@pytest.mark.parametrize("kind", ["hashing", "wordpiece"])
def test_mixed_batch_routes_ascii_rows_natively(engine, kind):
    """A batch that mixes ASCII and non-ASCII texts sends its ASCII rows to
    the native engine and the others to the Python path, in place: the ids
    equal the Python path's and the JAX package's (which sends the whole
    batch to Python)."""
    texts = [TEXTS[0], NON_ASCII[0], TEXTS[6], "", NON_ASCII[0] + " again", TEXTS[3]]
    if kind == "hashing":
        port, py, jx = (_hashing(True, max_len=48), _hashing(False, max_len=48),
                        _hashing(True, jax=True, max_len=48))
        native_obj, attr = port, "_native"
    else:
        vocab = _bundled_vocab()
        port, py, jx = (_wordpiece(vocab, True, max_len=48), _wordpiece(vocab, False, max_len=48),
                        _wordpiece(vocab, True, jax=True, max_len=48))
        native_obj, attr = port, "_wp_native"
    seen = []
    real = getattr(native_obj, attr)

    class Spy:
        def tokenize_batch(self, rows, *a):
            seen.append(list(rows))
            return real.tokenize_batch(rows, *a)

    setattr(native_obj, attr, Spy())
    ids, mask = port.encode_batch(texts)
    assert seen == [[t for t in texts if t.isascii()]]
    for ref in (py, jx):
        ref_ids, ref_mask = ref.encode_batch(texts)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(mask, ref_mask)


def test_small_vocab_raises_on_both_paths():
    """A vocab too small for a hash span raises (the Python path's check);
    the native engine is not asked to divide by zero."""
    tok = ptok.HashingTokenizer(vocab_size=103, max_len=16)
    assert tok._native is None
    with pytest.raises(ValueError):
        tok.encode_batch(["anything"])


def test_corpus_parity_both_vocabs(engine):
    """The bundled QA questions and passages, through each vocab."""
    import json

    train = ASSET_DIR.parent / "train"
    items = json.loads((train / "qa_pairs.json").read_text())["items"]
    texts = [it["query"] for it in items] + [it["passage"] for it in items]
    for make in VOCABS.values():
        vocab = make()
        _assert_same([_wordpiece(vocab, False, max_len=256),
                      _wordpiece(vocab, True, max_len=256)], texts)


def test_four_threads_at_once(engine):
    """4 threads tokenize at once through one tokenizer of each kind (as
    the query batcher's flush workers do): every result equals the
    single-threaded one."""
    vocab = _bert_sized_vocab()
    wp = _wordpiece(vocab, True, max_len=64)
    hs = _hashing(True, vocab_size=30522, max_len=64)
    batches = [[f"{t} {i}" for t in TEXTS] for i in range(16)]
    ref = {(kind, i): tok.encode_batch(b) for kind, tok in (("wp", wp), ("hs", hs))
           for i, b in enumerate(batches)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            out = []
            for _ in range(20):
                for kind, tok in (("wp", wp), ("hs", hs)):
                    out.append((kind, i, tok.encode_batch(batches[i])))
            return out

        with ThreadPoolExecutor(4) as pool:
            results = [r for f in [pool.submit(work, i) for i in range(len(batches))]
                       for r in f.result(timeout=120)]
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 16 * 20 * 2
    for kind, i, (ids, mask) in results:
        np.testing.assert_array_equal(ids, ref[(kind, i)][0])
        np.testing.assert_array_equal(mask, ref[(kind, i)][1])


def test_wordpiece_table_freed_with_its_tokenizer(engine):
    freed = []
    destroy = engine._lib.te_wp_destroy

    class Lib:
        def __getattr__(self, name):
            return getattr(engine._lib, name)

        def te_wp_destroy(self, h):
            freed.append(h)
            destroy(h)

    vocab = _bundled_vocab()
    tok = _wordpiece(vocab, True)
    handle = tok._wp_native
    handle._lib = Lib()
    h = handle._h
    ids = tok.encode_batch(TEXTS[:2])[0]
    del tok, handle
    import gc

    gc.collect()
    assert freed == [h]
    np.testing.assert_array_equal(_wordpiece(vocab, True).encode_batch(TEXTS[:2])[0], ids)


def test_concurrent_first_builds(tmp_path, monkeypatch):
    """Builds racing into one empty build directory (as test workers
    do) each compile to a name of their own and rename it into place:
    every one returns the same loadable library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with ThreadPoolExecutor(4) as pool:
        paths = [f.result(timeout=300) for f in [pool.submit(native.build) for _ in range(4)]]
    assert len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [paths[0].name]
    assert ctypes.CDLL(str(paths[0])).te_abi_version() == 2


def test_failed_build_is_logged_once(tmp_path, monkeypatch, caplog):
    broken = tmp_path / "text_engine.cpp"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_engine", None)
    monkeypatch.setattr(native, "_tried", False)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.get_engine() is None
        assert native.get_engine() is None
    warnings = [r for r in caplog.records if r.name == native.__name__]
    assert len(warnings) == 1 and "this is not C++" in warnings[0].getMessage()
    assert not list((tmp_path / "_build").glob("*.so"))
    # the tokenizers take the Python path, with the same ids
    tok = ptok.HashingTokenizer(max_len=32)
    assert tok._native is None
    np.testing.assert_array_equal(tok.encode_batch(TEXTS)[0],
                                  ptok.HashingTokenizer(max_len=32, use_native=False)
                                  .encode_batch(TEXTS)[0])


@pytest.mark.cuda
def test_native_ids_on_the_card(engine):
    """On the card's machine: the engine builds there, and its ids, moved
    to the card, equal the Python path's for both vocabs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for make in VOCABS.values():
        vocab = make()
        nat = _wordpiece(vocab, True, max_len=256).encode_batch(TEXTS)
        py = _wordpiece(vocab, False, max_len=256).encode_batch(TEXTS)
        for a, b in zip(nat, py):
            assert torch.equal(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())

