"""The traffic generators: the same seed gives the same inputs, another
seed other inputs, and every seed the same sizes in another order."""

from __future__ import annotations

import itertools

from portbench import data

BIG = 2 ** 31 + 12345  # seeds go past 32 signed bits


def _take(gen, n):
    return list(itertools.islice(gen, n))


def test_documents_are_distinct_and_sized_alike():
    a = _take(data.document_batches(BIG, 64, 2, 6), 4)
    assert a == _take(data.document_batches(BIG, 64, 2, 6), 4)
    assert a != _take(data.document_batches(7, 64, 2, 6), 4)
    flat = [d for b in a for d in b]
    assert len(set(flat)) == len(flat)
    counts = [sorted(d[0].count("\n\n") + 1 for d in b) for b in a]
    assert all(c == counts[0] for c in counts) and min(counts[0]) == 2 and max(counts[0]) == 6


def test_pairs_repeat_and_keep_the_mix():
    a = _take(data.pair_batches(BIG, 256, 0.1640625, 3, 12), 3)
    assert a == _take(data.pair_batches(BIG, 256, 0.1640625, 3, 12), 3)
    assert a != _take(data.pair_batches(3, 256, 0.1640625, 3, 12), 3)
    _, questions, _ = data.bundled()
    qs = set(questions)
    for b in a:
        assert sum(1 for q, _ in b if q in qs) >= 42
        assert len(set(b)) == 256


def test_filler_rows_are_seeded_blocks():
    import torch

    x = data.filler_block(BIG, 0, 2 * data.FILL_BLOCK, 8, "cpu")
    y = data.filler_block(BIG, data.FILL_BLOCK, 100, 8, "cpu")
    torch.testing.assert_close(x[data.FILL_BLOCK:data.FILL_BLOCK + 100], y, rtol=0, atol=0)
    torch.testing.assert_close(torch.linalg.vector_norm(x, dim=1),
                               torch.ones(2 * data.FILL_BLOCK))
    assert not torch.equal(x[:100], data.filler_block(BIG + 1, 0, 100, 8, "cpu"))
