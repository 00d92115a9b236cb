"""Frozen copy of the Python path of the port's WordPiece tokenizer
(``models/tokenizer.py``): greedy longest-match-first WordPiece over an
explicit vocab, [CLS] text [SEP], cut at ``max_len``, padded."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.IGNORECASE)


def load_vocab(path) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            vocab[line.rstrip("\n")] = i
    return vocab


class WordPiece:
    def __init__(self, vocab: Dict[str, int], max_len: int) -> None:
        self.vocab = vocab
        self.max_len = max_len
        self.unk = vocab.get("[UNK]", 100)
        self.cls = vocab.get("[CLS]", 101)
        self.sep = vocab.get("[SEP]", 102)
        self.pad = vocab.get("[PAD]", 0)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
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

    def ids(self, text: str) -> List[int]:
        """[CLS] pieces [SEP], cut to ``max_len``."""
        pieces: List[int] = []
        for w in _WORD_RE.findall(text.lower()):
            pieces.extend(self._wordpiece(w))
        return [self.cls] + pieces[: self.max_len - 2] + [self.sep]

    def length(self, text: str) -> int:
        """Real tokens of ``text`` after the cut."""
        return len(self.ids(text))

    def batch(self, texts: Sequence[str], width: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) (B, width) int64: ``width`` defaults to the longest row."""
        rows = [self.ids(t) for t in texts]
        width = width or max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad, dtype=np.int64)
        mask = np.zeros((len(rows), width), dtype=np.int64)
        for b, r in enumerate(rows):
            ids[b, : len(r)] = r
            mask[b, : len(r)] = 1
        return ids, mask
