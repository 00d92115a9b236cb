"""Tokenizers of the encoder (pure-Python path).

* ``WordPieceTokenizer`` — greedy longest-match-first WordPiece over an
  explicit vocab (the bundled checkpoint's ``vocab.txt``).
* ``HashingTokenizer`` — dependency-free fallback: lowercase word split,
  long words broken into fixed-size pieces, pieces hashed (FNV-1a) into
  the vocab id space.

Both produce static-shape ``(batch, max_len)`` int32 ids + masks and are
id-for-id the JAX package's pure-Python tokenizers; that package's native
C++ engine (bit-exact with this path on ASCII input) is not ported yet.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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


def _hash_id(piece: str, vocab_size: int) -> int:
    first = _first_regular(vocab_size)
    span = vocab_size - first
    return first + _fnv1a(piece.encode("utf-8")) % span


class HashingTokenizer:
    name = "hashing"

    def __init__(self, vocab_size: int = 30522, max_len: int = 256,
                 piece_len: int = 6) -> None:
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.piece_len = piece_len

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
        return len(self.tokenize(text)) + 2  # [CLS] + [SEP]

    def encode_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids (B, max_len) int32, mask (B, max_len) int32)."""
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
    """Greedy longest-match-first WordPiece over an explicit vocab."""

    name = "wordpiece"

    def __init__(self, vocab: Dict[str, int], max_len: int = 256) -> None:
        self.vocab = vocab
        self.max_len = max_len
        self.vocab_size = max(vocab.values()) + 1
        self.unk = vocab.get("[UNK]", UNK_ID)
        self.cls = vocab.get("[CLS]", CLS_ID)
        self.sep = vocab.get("[SEP]", SEP_ID)
        self.pad = vocab.get("[PAD]", PAD_ID)
        self._max_chars = 100

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
        return len(self.tokenize_ids(text)) + 2

    def encode_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        B = len(texts)
        ids = np.full((B, self.max_len), self.pad, dtype=np.int32)
        mask = np.zeros((B, self.max_len), dtype=np.int32)
        for b, text in enumerate(texts):
            row = [self.cls] + self.tokenize_ids(text)[: self.max_len - 2] + [self.sep]
            ids[b, : len(row)] = row
            mask[b, : len(row)] = 1
        return ids, mask
