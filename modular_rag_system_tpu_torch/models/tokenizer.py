"""Tokenizers of the encoder.

* ``WordPieceTokenizer`` — greedy longest-match-first WordPiece over an
  explicit vocab (the bundled checkpoint's or an HF checkpoint's
  ``vocab.txt``).
* ``HashingTokenizer`` — dependency-free fallback: lowercase word split,
  long words broken into fixed-size pieces, pieces hashed (FNV-1a) into
  the vocab id space.

Both produce static-shape ``(batch, max_len)`` int32 ids + masks, id for
id the JAX package's tokenizers.  With ``use_native=True`` (the default)
every text that encodes to UTF-8 runs through the native C++ engine
(``native/text_engine.cpp``, bit-exact with the Python path on such
text); a text holding a lone surrogate, and every text when the engine
cannot be built, takes the Python path, row by row in a batch.  The JAX
package's engine takes ASCII only, and sends a whole batch to Python when
one text is not ASCII (the ids are the same either way).  With the
tracer on, ``encode_batch`` counts its rows ("tokenizer.rows") and those
the native engine took ("tokenizer.native_rows").
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from modular_rag_system_tpu_torch.native import get_engine
from modular_rag_system_tpu_torch.utils.profiling import TRACER

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.IGNORECASE)

# Special ids (BERT-compatible layout)
PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
_FIRST_REGULAR_ID = 999  # hash ids start after special/unused range


def _fnv1a(data: bytes) -> int:
    """FNV-1a 32-bit (the hash of the JAX package's tokenizer, id for id)."""
    h = 0x811C9DC5
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def _first_regular(vocab_size: int) -> int:
    """First non-special id: BERT-style 999 for real-size vocabs, packed

    right after the specials for tiny test vocabs (guards the modulo
    span from going non-positive, which produced out-of-range ids)."""
    if vocab_size > 2 * _FIRST_REGULAR_ID:
        return _FIRST_REGULAR_ID
    if vocab_size <= SEP_ID + 2:
        raise ValueError(f"vocab_size {vocab_size} too small (min {SEP_ID + 2})")
    return SEP_ID + 1


def _utf8(text: str) -> bool:
    """Whether ``text``, and so its lowercase, encodes to UTF-8: every str
    but one that holds a lone surrogate."""
    if text.isascii():
        return True
    try:
        text.encode("utf-8")
    except UnicodeEncodeError:
        return False
    return True


def _by_row(texts: Sequence[str], native, python) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask) of ``texts``: the rows that encode to UTF-8 through
    ``native`` (None: no engine), the others through ``python`` (rows
    tokenize independently, and the two paths give the same ids on such
    text)."""
    takes = [native is not None and _utf8(t) for t in texts]
    rows = [i for i, ok in enumerate(takes) if ok]
    if TRACER.on:
        TRACER.count("tokenizer.rows", len(texts))
        TRACER.count("tokenizer.native_rows", len(rows))
    if not rows:
        return python(texts)
    if len(rows) == len(texts):
        return native(texts)
    other = [i for i, ok in enumerate(takes) if not ok]
    ids_a, mask_a = native([texts[i] for i in rows])
    ids_o, mask_o = python([texts[i] for i in other])
    ids = np.empty((len(texts), ids_a.shape[1]), np.int32)
    mask = np.empty_like(ids)
    ids[rows], mask[rows] = ids_a, mask_a
    ids[other], mask[other] = ids_o, mask_o
    return ids, mask


def _hash_id(piece: str, vocab_size: int) -> int:
    first = _first_regular(vocab_size)
    span = vocab_size - first
    return first + _fnv1a(piece.encode("utf-8")) % span


class HashingTokenizer:
    name = "hashing"

    def __init__(self, vocab_size: int = 30522, max_len: int = 256,
                 piece_len: int = 6, use_native: bool = True) -> None:
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.piece_len = piece_len
        # a vocab too small for a hash span raises on the Python path
        # (``_first_regular``); the native engine would divide by zero
        self._native = get_engine() if use_native and vocab_size > SEP_ID + 2 else None

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for w in _WORD_RE.findall(text.lower()):
            if len(w) <= self.piece_len:
                pieces.append(w)
            else:
                pieces.append(w[: self.piece_len])
                for i in range(self.piece_len, len(w), self.piece_len):
                    pieces.append("##" + w[i : i + self.piece_len])
        return pieces

    def token_count(self, text: str) -> int:
        if self._native is not None and _utf8(text):
            return self._native.token_count(text, self.piece_len)
        return len(self.tokenize(text)) + 2  # [CLS] + [SEP]

    def encode_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids (B, max_len) int32, mask (B, max_len) int32)."""
        native = None if self._native is None else (lambda rows: self._native.tokenize_batch(
            rows, self.max_len, self.vocab_size, self.piece_len))
        return _by_row(texts, native, self._encode_python)

    def _encode_python(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        B = len(texts)
        ids = np.full((B, self.max_len), PAD_ID, dtype=np.int32)
        mask = np.zeros((B, self.max_len), dtype=np.int32)
        for b, text in enumerate(texts):
            pieces = self.tokenize(text)[: self.max_len - 2]
            row = [CLS_ID] + [_hash_id(p, self.vocab_size) for p in pieces] + [SEP_ID]
            ids[b, : len(row)] = row
            mask[b, : len(row)] = 1
        return ids, mask


def load_vocab(path: str) -> Dict[str, int]:
    """WordPiece vocab file (one piece per line) -> piece -> id."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            vocab[line.rstrip("\n")] = i
    return vocab


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over an explicit vocab.

    The native table holds every piece of the vocab (as UTF-8) but the
    bracketed specials, which ``_WORD_RE`` never yields as a word, and a
    piece holding a lone surrogate, which no row the engine takes can
    match: so its rows stay bit-exact with the Python path."""

    name = "wordpiece"

    def __init__(self, vocab: Dict[str, int], max_len: int = 256,
                 use_native: bool = True) -> None:
        self.vocab = vocab
        self.max_len = max_len
        self.vocab_size = max(vocab.values()) + 1
        self.unk = vocab.get("[UNK]", UNK_ID)
        self.cls = vocab.get("[CLS]", CLS_ID)
        self.sep = vocab.get("[SEP]", SEP_ID)
        self.pad = vocab.get("[PAD]", PAD_ID)
        self._max_chars = 100
        self._wp_native = None
        eng = get_engine() if use_native else None
        if eng is not None:
            items = [(p, i) for p, i in vocab.items()
                     if p and _utf8(p) and not (p.startswith("[") and p.endswith("]"))]
            self._wp_native = eng.wp_create(
                [p.encode("utf-8") for p, _ in items],
                np.array([i for _, i in items], dtype=np.int32),
                self.unk, self.cls, self.sep, self.pad)

    @classmethod
    def from_vocab_file(cls, path: str, max_len: int = 256) -> "WordPieceTokenizer":
        return cls(load_vocab(path), max_len)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self._max_chars:
            return [self.unk]
        out: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur: Optional[int] = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            out.append(cur)
            start = end
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for w in _WORD_RE.findall(text.lower()):
            ids.extend(self._wordpiece(w))
        return ids

    def token_count(self, text: str) -> int:
        if self._wp_native is not None and _utf8(text):
            return self._wp_native.token_count(text)
        return len(self.tokenize_ids(text)) + 2

    def encode_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        native = None if self._wp_native is None else (
            lambda rows: self._wp_native.tokenize_batch(rows, self.max_len))
        return _by_row(texts, native, self._encode_python)

    def _encode_python(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        B = len(texts)
        ids = np.full((B, self.max_len), self.pad, dtype=np.int32)
        mask = np.zeros((B, self.max_len), dtype=np.int32)
        for b, text in enumerate(texts):
            row = [self.cls] + self.tokenize_ids(text)[: self.max_len - 2] + [self.sep]
            ids[b, : len(row)] = row
            mask[b, : len(row)] = 1
        return ids, mask
