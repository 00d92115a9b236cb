"""The port's native text engine against the JAX package's and the Python path.

Both tokenizers (hashing and WordPiece, under the bundled 16,384-piece
vocab, a 30,522-piece BERT-sized one and one with multibyte pieces) must
give the same ids, masks and token counts through the port's native
engine, the JAX package's native engine (ASCII only: it sends other
batches to Python) and the port's and the JAX package's Python paths: id
for id, on ASCII text, on every code point of the BMP but the surrogates
and a seeded sample of the astral planes (alone and inside a word), on
seeded texts mixing Unicode's whitespace, the four code points that
``_WORD_RE``'s ``[a-z0-9]`` takes under ``IGNORECASE``, accents, CJK,
emoji, combining marks and words past 100 code points, on one batch of
the long-document benchmark traffic, with truncation and empty strings,
and from 4 threads at once.  A row holding a lone surrogate (which does
not encode to UTF-8) takes the Python path, in place in its batch.  The
build is checked for concurrent first builds (a temporary name renamed
into place) and for a failure that is logged with the compiler's output.

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
# Python's \s on a str: the 29 code points str.isspace() accepts
WHITESPACE = "".join(map(chr, [*range(0x09, 0x0E), *range(0x1C, 0x21), 0x85, 0xA0, 0x1680,
                               *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                               0x3000]))
# besides a-z, [a-z0-9] under re.IGNORECASE takes these four (İ and the
# Kelvin sign lowercase to ASCII; ı and ſ stay, as 2-byte word characters)
CASE_FOLDED = "\u0130\u0131\u017f\u212a"


def _every_code_point(chunk=2048):
    """Every code point of the BMP but the surrogates, and a seeded 8,192
    of the astral planes, each alone and between word characters
    (``x{c}y``), ``chunk`` code points a text."""
    rng = np.random.default_rng(23)
    astral = np.sort(rng.choice(np.arange(0x10000, 0x110000), 8192, replace=False))
    cps = [c for c in range(0x10000) if not 0xD800 <= c <= 0xDFFF] + astral.tolist()
    return [" ".join(f"{chr(c)} x{chr(c)}y" for c in cps[i:i + chunk])
            for i in range(0, len(cps), chunk)]


_MIXED = [*WHITESPACE, *CASE_FOLDED, "İstanbul", "KELVIN", "ıs", "ſt", "kıss", "ıſ", "ﬁ", "é",
          "Ünïcödé", "façade", "naïve", "e\u0301", "n\u0303o", "a\u0338\u0301", "東京",
          "日本語の文章", "中文", "한국어", "😀", "👍🏽", "🇫🇷", "𝔘𝔫𝔦", "𠜎", "—", "â", "–",
          "“quoted”", "‘single’", "…", "€100", "½", "²", "ⅷ", "ß", "ẞ", "Σίσυφος", "Ωmega",
          "ǅ", "x" + "é" * 120, "ı" * 101, "ı" * 100, "ſ" * 99 + "a", "aı" * 60, "ı" * 40,
          "ſ" * 60, "xııı", "word", "unaffable", "12345", "x" * 150, ",", "#", "##ing", "."]


def _mixed_texts(n=48, seed=23):
    """Seeded texts of the pieces above, joined by a space, nothing (so
    neighbours merge into one word across multibyte characters), a
    newline or Unicode's wider spaces; every fourth up to 400 pieces
    long, past the parity tests' ``max_len``."""
    rng = np.random.default_rng(seed)
    seps = [" ", "", "", "\n", "\u3000", "\xa0", "\u2009"]
    texts = []
    for i in range(n):
        k = int(rng.integers(1, 400 if i % 4 == 0 else 60))
        texts.append("".join(_MIXED[p] + seps[q] for p, q in
                             zip(rng.integers(len(_MIXED), size=k), rng.integers(len(seps), size=k))))
    return texts + ["", WHITESPACE, "İ", "\u212a", "İı" * 3]


def _longdoc_batch():
    """One batch of the long-document cell's traffic (``ingest-longdocs16``'s
    parameters, seed 1): 8 documents of bundled passages joined, most of
    them not ASCII."""
    from portbench import common, data

    p = common.mix("ingest-longdocs16")
    batch = next(data.document_batches(1, p["batch"], p["pieces_min"], p["pieces_max"]))
    return [text for text, _ in batch]


# the corpora beyond TEXTS and NON_ASCII, each with the max_len it runs at
# (None: the case's own, which cuts the long mixed texts)
CORPORA = {"code_points": (_every_code_point, 16384), "mixed": (_mixed_texts, None),
           "longdocs": (_longdoc_batch, 8192)}


def _cases(keys):
    """Each key alone (TEXTS and NON_ASCII), then with each corpus."""
    return ([pytest.param(k, None, id=k) for k in keys]
            + [pytest.param(k, c, id=f"{k}-{c}") for k in keys for c in CORPORA])


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


def _multibyte_vocab():
    """The bundled pieces and some multibyte ones: pieces of ı and ſ (the
    only multibyte code points inside a word), among them the longest
    plain piece and continuation in bytes (which bound the native
    engine's candidates), and single characters of several widths."""
    vocab = dict(_bundled_vocab())
    n = max(vocab.values()) + 1
    extra = ["ı", "ıs", "kı", "kıs", "##ı", "##ıs", "##ſ", "##ſt", "ſt", "ı" * 30,
             "##" + "ſ" * 25, "xııı", "##ıı", "é", "東", "京", "😀", "ß", "â", "##â", "İ"]
    vocab.update({p: n + i for i, p in enumerate(extra)})
    return vocab


VOCABS = {"bundled": _bundled_vocab, "bert_sized": _bert_sized_vocab,
          "multibyte": _multibyte_vocab}
HASHING = {"30522": dict(vocab_size=30522, max_len=64),
           "16384": dict(vocab_size=16384, max_len=128),
           "512-piece4": dict(vocab_size=512, max_len=32, piece_len=4)}


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


def _corpus(corpus, max_len):
    """(texts, max_len) of a corpus case."""
    make, own = CORPORA[corpus]
    return make(), own or max_len


@pytest.mark.parametrize("case,corpus", _cases(HASHING))
def test_hashing_parity(engine, case, corpus):
    from modular_rag_system_tpu.native import get_engine as jax_get_engine

    kw = dict(HASHING[case])
    if corpus is not None:
        texts, kw["max_len"] = _corpus(corpus, kw["max_len"])
    port_native = _hashing(True, **kw)
    assert port_native._native is engine
    toks = [_hashing(False, **kw), port_native]
    if jax_get_engine() is not None:
        toks.append(_hashing(True, jax=True, **kw))  # other than ASCII: its Python path
    if corpus is None:
        _assert_same(toks, [t for t in TEXTS if t])
        _assert_same(toks, TEXTS)
        _assert_same(toks, NON_ASCII)
    else:
        _assert_same(toks, texts)


@pytest.mark.parametrize("vocab_name,corpus", _cases(VOCABS))
def test_wordpiece_parity(engine, vocab_name, corpus):
    from modular_rag_system_tpu.native import get_engine as jax_get_engine

    vocab = VOCABS[vocab_name]()
    max_len = 64
    if corpus is not None:
        texts, max_len = _corpus(corpus, max_len)
    port_native = _wordpiece(vocab, True, max_len=max_len)
    assert port_native._wp_native is not None
    toks = [_wordpiece(vocab, False, max_len=max_len), port_native,
            _wordpiece(vocab, False, jax=True, max_len=max_len)]
    if jax_get_engine() is not None:
        toks.append(_wordpiece(vocab, True, jax=True, max_len=max_len))
    if corpus is None:
        _assert_same(toks, TEXTS)
        _assert_same(toks, NON_ASCII)
    else:
        _assert_same(toks, texts)


@pytest.mark.parametrize("kind", ["hashing", "wordpiece"])
def test_mixed_batch_routes_utf8_rows_natively(engine, kind):
    """A batch sends every row that encodes to UTF-8, ASCII or not, to the
    native engine and a row holding a lone surrogate to the Python path,
    in place: the ids equal the Python path's and the JAX package's
    (whose engine takes ASCII only, so it sends the whole batch to
    Python).  The hashing tokenizer's Python path hashes a piece's UTF-8
    bytes, so it raises on a lone surrogate, as the JAX package's does:
    its ids are checked on the batch without that row."""
    lone = "half a pair \ud83d here"
    texts = [TEXTS[0], NON_ASCII[0], TEXTS[6], "", lone, NON_ASCII[0] + " again", TEXTS[3]]
    utf8 = [t for t in texts if t is not lone]
    if kind == "hashing":
        port, py, jx = (_hashing(True, max_len=48), _hashing(False, max_len=48),
                        _hashing(True, jax=True, max_len=48))
        attr = "_native"
    else:
        vocab = _bundled_vocab()
        port, py, jx = (_wordpiece(vocab, True, max_len=48), _wordpiece(vocab, False, max_len=48),
                        _wordpiece(vocab, True, jax=True, max_len=48))
        attr = "_wp_native"
    native_seen, python_seen = [], []
    real, real_python = getattr(port, attr), port._encode_python

    class Spy:
        def tokenize_batch(self, rows, *a):
            native_seen.append(list(rows))
            return real.tokenize_batch(rows, *a)

    def python_spy(rows):
        python_seen.append(list(rows))
        return real_python(rows)

    setattr(port, attr, Spy())
    port._encode_python = python_spy
    if kind == "hashing":
        for tok in (port, py, jx):
            with pytest.raises(UnicodeEncodeError):
                tok.encode_batch(texts)
        assert native_seen == [utf8] and python_seen == [[lone]]
        native_seen.clear(), python_seen.clear()
        texts = utf8
        ids, mask = port.encode_batch(texts)
        assert native_seen == [utf8] and python_seen == []
    else:
        ids, mask = port.encode_batch(texts)
        assert native_seen == [utf8] and python_seen == [[lone]]
        assert port.token_count(lone) == py.token_count(lone) == jx.token_count(lone)
    for ref in (py, jx):
        ref_ids, ref_mask = ref.encode_batch(texts)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(mask, ref_mask)


def test_rows_counted_under_the_tracer(engine):
    """With the tracer on, ``encode_batch`` counts its rows
    ("tokenizer.rows") and those the native engine took
    ("tokenizer.native_rows"), which the benchmark's
    ``ingest.tokenize_native_share`` reads over a window; off, nothing."""
    from portbench import common
    from portbench.hooks import Recorder

    from modular_rag_system_tpu_torch.utils.profiling import TRACER

    class Run:
        def __init__(self):
            self.state, self.units = {}, 1

        def tick(self):
            pass

    texts = [TEXTS[0], NON_ASCII[0], "half \ud83d", ""]
    nat, py = _wordpiece(_bundled_vocab(), True), _wordpiece(_bundled_vocab(), False)
    TRACER.reset()
    nat.encode_batch(texts)
    assert TRACER.counters() == {}
    reader, run, rec = common.layer("ingest.tokenize_native_share"), Run(), Recorder(torch.device("cpu"))
    try:
        reader.install(run, rec)
        assert TRACER.on
        rec.active = True
        nat.encode_batch(texts)
        py.encode_batch(texts[:2])
        nat.encode_batch([])
        run.tick()
        rec.active = False
        counts = TRACER.counters()
        share = reader.read(run, rec, None)
    finally:
        rec.restore()
        TRACER.disable()
        TRACER.reset()
    assert counts["tokenizer.rows"] == 6 and counts["tokenizer.native_rows"] == 3
    assert share == 50.0


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
    assert ctypes.CDLL(str(paths[0])).te_abi_version() == native._ABI


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
    to the card, equal the Python path's for every vocab, on ASCII text,
    on the seeded mixed Unicode texts and on a batch of long documents."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for make in VOCABS.values():
        vocab = make()
        for texts, max_len in ((TEXTS, 256), (NON_ASCII + _mixed_texts(), 256),
                               (_longdoc_batch(), 8192)):
            nat = _wordpiece(vocab, True, max_len=max_len).encode_batch(texts)
            py = _wordpiece(vocab, False, max_len=max_len).encode_batch(texts)
            for a, b in zip(nat, py):
                assert torch.equal(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())

