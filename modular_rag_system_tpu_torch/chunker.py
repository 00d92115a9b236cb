"""Content-type-aware text chunker.

Re-implements the semantics of the reference ``TextChunker``
(``embedding_pipeline.py:72-329``): a 512-token budget with 50-token
overlap and per-content-type grouping strategies —

* ``keystroke``: sentences grouped into chunks, with trailing sentences
  re-used as overlap for the next chunk,
* ``ocr``: lines grouped, layout preserved (lines joined by ``\\n``),
* ``document``: paragraphs grouped; a paragraph that alone exceeds the
  budget is split by sentence,
* ``query``: never chunked (``embedding_pipeline.py:98-99``).

Token counting uses a pluggable counter (the framework passes the real
encoder tokenizer); the fallback is the reference's ``words * 1.3``
estimate (``embedding_pipeline.py:301-310``).

Chunking is deliberately kept on the host: chunk boundaries are
*semantic* (they define retrieval units), so this is orchestration, not
device compute.  The long axis the device scales is the corpus, not the
sequence (SURVEY §5 "long-context").
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

from modular_rag_system_tpu_torch.types import Chunk

TokenCounter = Callable[[str], int]

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+")
_PARA_RE = re.compile(r"\n\s*\n")


def _estimate_tokens(text: str) -> int:
    """words * 1.3 fallback (reference ``embedding_pipeline.py:301-310``)."""
    return max(1, int(len(text.split()) * 1.3))


def split_sentences(text: str) -> List[str]:
    parts = [s.strip() for s in _SENTENCE_RE.split(text)]
    return [s for s in parts if s]


def split_paragraphs(text: str) -> List[str]:
    parts = [p.strip() for p in _PARA_RE.split(text)]
    return [p for p in parts if p]


class TextChunker:
    def __init__(
        self,
        chunk_size_tokens: int = 512,
        overlap_tokens: int = 50,
        token_counter: Optional[TokenCounter] = None,
    ) -> None:
        if overlap_tokens >= chunk_size_tokens:
            raise ValueError("overlap must be smaller than chunk size")
        self.chunk_size = chunk_size_tokens
        self.overlap = overlap_tokens
        self.count_tokens = token_counter or _estimate_tokens

    # ------------------------------------------------------------------
    def chunk_text(self, text: str, content_type: str = "document") -> List[Chunk]:
        text = text.strip()
        if not text:
            return []
        if content_type == "query":
            units = [text]  # queries are never chunked
            chunks = [text]
        elif content_type == "ocr":
            units = [ln for ln in text.splitlines() if ln.strip()]
            chunks = self._pack(units, joiner="\n", overlap_units=False)
        elif content_type == "keystroke":
            units = split_sentences(text) or [text]
            chunks = self._pack(units, joiner=" ", overlap_units=True)
        else:  # document and anything unknown
            units = []
            for para in split_paragraphs(text) or [text]:
                if self.count_tokens(para) > self.chunk_size:
                    units.extend(split_sentences(para) or [para])
                else:
                    units.append(para)
            chunks = self._pack(units, joiner="\n\n", overlap_units=True)

        total = len(chunks)
        return [
            Chunk(
                text=c,
                index=i,
                total=total,
                content_type=content_type,
                token_count=self.count_tokens(c),
            )
            for i, c in enumerate(chunks)
        ]

    # ------------------------------------------------------------------
    def _pack(self, units: List[str], joiner: str, overlap_units: bool) -> List[str]:
        """Greedily pack units into token-budgeted chunks.

        With ``overlap_units``, trailing units totalling <= ``overlap``
        tokens are carried into the next chunk (the reference's
        sentence-overlap, ``embedding_pipeline.py:~200-260``).
        """
        chunks: List[str] = []
        cur: List[str] = []
        cur_tokens = 0
        for unit in units:
            t = self.count_tokens(unit)
            if t > self.chunk_size and not cur:
                # an indivisible oversized unit: hard-split by words
                chunks.extend(self._hard_split(unit))
                continue
            if cur and cur_tokens + t > self.chunk_size:
                chunks.append(joiner.join(cur))
                if overlap_units:
                    cur = self._overlap_tail(cur)
                    cur_tokens = sum(self.count_tokens(u) for u in cur)
                else:
                    cur, cur_tokens = [], 0
                if t > self.chunk_size:
                    chunks.extend(self._hard_split(unit))
                    continue
            cur.append(unit)
            cur_tokens += t
        if cur:
            tail = joiner.join(cur)
            # Don't emit a pure-overlap tail chunk (it would duplicate the
            # previous chunk's ending verbatim).
            if not chunks or tail not in chunks[-1]:
                chunks.append(tail)
        return chunks

    def _overlap_tail(self, units: List[str]) -> List[str]:
        tail: List[str] = []
        tokens = 0
        for unit in reversed(units):
            t = self.count_tokens(unit)
            if tokens + t > self.overlap:
                break
            tail.insert(0, unit)
            tokens += t
        return tail

    def _hard_split(self, text: str) -> List[str]:
        """Word-level split for a unit that alone exceeds the budget."""
        words = text.split()
        out: List[str] = []
        cur: List[str] = []
        for w in words:
            cur.append(w)
            if self.count_tokens(" ".join(cur)) >= self.chunk_size:
                out.append(" ".join(cur))
                cur = []
        if cur:
            out.append(" ".join(cur))
        return out
