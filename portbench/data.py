"""The benchmark's inputs, all made from ``--seed``: the bundled corpus
read by path, documents to ingest, training pairs, filler rows and
their documents.

Every seed draws the same sizes (the number of pieces a document joins,
the lengths of query spans, the mix of pair kinds) in another order, so the seed changes which texts are sent and not how much work
they make.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Dict, Iterator, List, Tuple

import numpy as np

from portbench.common import ASSETS, read_json

# filler rows are made on the device in blocks of this many rows
FILL_BLOCK = 65_536
# every filler row carries this timestamp (seconds since the epoch)
FILLER_TS = 1_700_000_100.0


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each use of one seed."""
    h = hashlib.sha256(f"{seed}:{stream}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:16], "little"))


def torch_seed(seed: int, stream: str) -> int:
    h = hashlib.sha256(f"{seed}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


@lru_cache(maxsize=1)
def bundled() -> Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]:
    """(knowledge sentences, QA questions, QA passages) of the bundled
    training files."""
    train = ASSETS / "train"
    know = read_json(train / "knowledge.json")["sentences"]
    items = read_json(train / "qa_pairs.json")["items"]
    return (tuple(know), tuple(it["query"] for it in items),
            tuple(it["passage"] for it in items))


def content_id(content: str, source: str) -> str:
    """The store's content-hash id of a document (sha256 of the source, a
    zero byte and the content, 32 hex digits)."""
    h = hashlib.sha256()
    h.update(source.encode("utf-8"))
    h.update(b"\x00")
    h.update(content.encode("utf-8"))
    return h.hexdigest()[:32]


def filler_id(i: int) -> str:
    return f"filler-{i:010d}"


def filler_content(i: int) -> str:
    return f"filler row {i}"


def filler_block(seed: int, start: int, n: int, dim: int, device):
    """Filler rows ``start .. start + n`` (unit f32 rows on ``device``),
    drawn block by block from the seed: any caller that asks for the same
    rows gets the same values.  ``start`` is a multiple of FILL_BLOCK."""
    import torch

    if start % FILL_BLOCK:
        raise ValueError(f"filler blocks start at multiples of {FILL_BLOCK}")
    parts = []
    for b in range(start, start + n, FILL_BLOCK):
        g = torch.Generator(device=device).manual_seed(
            torch_seed(seed, f"filler:{dim}:{b // FILL_BLOCK}"))
        x = torch.randn((FILL_BLOCK, dim), generator=g, device=device)
        parts.append(x / torch.linalg.vector_norm(x, dim=1, keepdim=True))
    out = torch.cat(parts) if len(parts) > 1 else parts[0]
    return out[:n]


def _span_lengths(n: int, lo: int, hi: int) -> List[int]:
    """n span lengths spread evenly over lo..hi: the same for every seed."""
    return [lo + (i * (hi - lo + 1)) // n for i in range(n)]


def document_batches(seed: int, batch: int, pieces_min: int, pieces_max: int
                     ) -> Iterator[List[Tuple[str, str]]]:
    """Endless batches of distinct (content, source) documents: each joins
    pieces_min..pieces_max bundled passages or sentences (the same piece
    counts every batch), chosen and ordered by the seed."""
    know, _, passages = bundled()
    pool = list(passages) + list(know)
    r = rng(seed, "documents")
    counts = np.array(_span_lengths(batch, pieces_min, pieces_max))
    seen = set()
    while True:
        out = []
        for c in r.permutation(counts):
            while True:
                pick = tuple(int(x) for x in r.choice(len(pool), size=int(c), replace=False))
                if pick not in seen:
                    seen.add(pick)
                    break
            out.append(("\n\n".join(pool[p] for p in pick), "notes"))
        yield out


def pair_pool(seed: int, span_min: int, span_max: int
              ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """(QA pairs, knowledge pairs): the bundled (question, passage) pairs,
    and for each knowledge sentence a (span of it, sentence) pair with a
    span length drawn from span_min..span_max (the same lengths for
    every seed)."""
    know, questions, passages = bundled()
    r = rng(seed, "pairs")
    qa = list(zip(questions, passages))
    lengths = r.permutation(np.array(_span_lengths(len(know), span_min, span_max)))
    kp = []
    for s, L in zip(know, lengths):
        words = s.split()
        L = min(int(L), len(words))
        at = int(r.integers(len(words) - L + 1))
        kp.append((" ".join(words[at:at + L]), s))
    return qa, kp


def pair_batches(seed: int, batch: int, qa_share: float, span_min: int, span_max: int
                 ) -> Iterator[List[Tuple[str, str]]]:
    """Endless batches of (query, positive) pairs, ``qa_share`` of each from
    the QA pairs and the rest from the knowledge pairs; each pool is
    walked in an order drawn from the seed, so consecutive batches share
    no pair until a pool is used up."""
    qa, kp = pair_pool(seed, span_min, span_max)
    r = rng(seed, "pair-order")
    n_qa = int(round(batch * qa_share))
    pools = [(qa, n_qa), (kp, batch - n_qa)]
    orders = [r.permutation(len(p)) for p, _ in pools]
    ats = [0, 0]
    while True:
        out = []
        for j, (pool, n) in enumerate(pools):
            for _ in range(n):
                if ats[j] == len(pool):
                    orders[j], ats[j] = r.permutation(len(pool)), 0
                out.append(pool[orders[j][ats[j]]])
                ats[j] += 1
        yield [out[i] for i in r.permutation(len(out))]


def minilm_vocab(vocab_size: int) -> Dict[str, int]:
    """The bundled WordPiece vocab padded with ``[unusedN]`` pieces to
    ``vocab_size`` ids (the real all-MiniLM-L6-v2 vocab is not here)."""
    vocab: Dict[str, int] = {}
    with open(ASSETS / "default_encoder" / "vocab.txt", encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            vocab[line.rstrip("\n")] = i
    n = max(vocab.values()) + 1
    vocab.update({f"[unused{i}]": n + i for i in range(vocab_size - n)})
    return vocab
