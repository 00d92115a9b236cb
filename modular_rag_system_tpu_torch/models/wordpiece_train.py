"""WordPiece vocabulary training (BPE merges) — zero-dependency.

The container has no HF tokenizer cache, so the bundled default
encoder's vocabulary is trained here, on the harvested English corpus
(``models.corpus``).  Standard byte-pair-merge training restricted to
within-word pairs, emitting a BERT-style vocab: word-initial pieces
plain, continuations prefixed ``##``.  The greedy longest-match-first
``WordPieceTokenizer`` (``models.tokenizer``) consumes the result
directly; pre-tokenization (lowercase + ``_WORD_RE``) is shared so
training and inference see identical word streams.  The JAX package's
module of the same name, piece for piece (``load_vocab`` is the
tokenizer's).

Incremental pair-count maintenance keeps training O(merges * touched
words), not O(merges * corpus) — a few seconds for an 8k vocab over
100k unique words.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

from modular_rag_system_tpu_torch.models.tokenizer import _WORD_RE

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]


def word_counts(sentences: Sequence[str]) -> Dict[str, int]:
    counts: Dict[str, int] = collections.Counter()
    for s in sentences:
        for w in _WORD_RE.findall(s.lower()):
            counts[w] += 1
    return dict(counts)


def train_wordpiece(
    sentences: Sequence[str],
    vocab_size: int = 8192,
    min_pair_freq: int = 2,
    max_unique_words: int = 120_000,
    max_word_len: int = 24,
) -> Dict[str, int]:
    """Train a WordPiece vocab; returns {piece: id} including SPECIALS."""
    counts = word_counts(sentences)
    words = sorted(counts, key=lambda w: -counts[w])[:max_unique_words]
    # symbol sequences: first char plain, continuations ##-prefixed
    seqs: List[List[str]] = []
    freqs: List[int] = []
    for w in words:
        if len(w) > max_word_len:
            continue
        seqs.append([w[0]] + ["##" + c for c in w[1:]])
        freqs.append(counts[w])

    vocab: Dict[str, int] = {}
    for sp in SPECIALS:
        vocab[sp] = len(vocab)
    for seq in seqs:
        for sym in seq:
            if sym not in vocab:
                vocab[sym] = len(vocab)

    # pair stats with reverse index for incremental updates
    pair_count: Dict[Tuple[str, str], int] = collections.defaultdict(int)
    pair_words: Dict[Tuple[str, str], set] = collections.defaultdict(set)
    for wi, seq in enumerate(seqs):
        f = freqs[wi]
        for a, b in zip(seq, seq[1:]):
            pair_count[(a, b)] += f
            pair_words[(a, b)].add(wi)

    def merged_symbol(a: str, b: str) -> str:
        return a + (b[2:] if b.startswith("##") else b)

    while len(vocab) < vocab_size and pair_count:
        # most frequent pair; ties broken lexicographically for
        # determinism across runs
        (a, b), best = max(
            pair_count.items(), key=lambda kv: (kv[1], kv[0])
        )
        if best < min_pair_freq:
            break
        new_sym = merged_symbol(a, b)
        if new_sym not in vocab:
            vocab[new_sym] = len(vocab)
        touched = list(pair_words.pop((a, b), ()))
        pair_count.pop((a, b), None)
        for wi in touched:
            seq = seqs[wi]
            f = freqs[wi]
            # remove this word's contribution to all its pairs
            for pa, pb in zip(seq, seq[1:]):
                pc = pair_count.get((pa, pb))
                if pc is not None:
                    pc -= f
                    if pc <= 0:
                        pair_count.pop((pa, pb), None)
                        pair_words.pop((pa, pb), None)
                    else:
                        pair_count[(pa, pb)] = pc
                pw = pair_words.get((pa, pb))
                if pw is not None:
                    pw.discard(wi)
            # apply the merge left-to-right
            out: List[str] = []
            i = 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(new_sym)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[wi] = out
            # re-add contributions
            for pa, pb in zip(out, out[1:]):
                pair_count[(pa, pb)] += f
                pair_words[(pa, pb)].add(wi)
    return vocab


def save_vocab(vocab: Dict[str, int], path: str) -> None:
    inv = sorted(vocab.items(), key=lambda kv: kv[1])
    with open(path, "w", encoding="utf-8") as fh:
        for line_no, (piece, i) in enumerate(inv):
            if i != line_no:
                raise ValueError(f"vocab ids not dense at {piece!r}")
            fh.write(piece + "\n")

