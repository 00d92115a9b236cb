"""External (hand-written) retrieval eval of an encoder.

Scores retrieval on ``external_qa.json``, 304 hand-written query ->
passage pairs (38 topics x 8) with same-topic passages as hard
distractors, whose data path never touches the synthetic generator
(``models/synth.py``) or the training corpus.  The file is the JAX
package's asset (``modular_rag_system_tpu/assets/eval/``), read here as a
data file, as ``default_ckpt`` reads the bundled encoder.

Scoring: encode all passages and all queries with the same encoder,
cosine top-k on the host in numpy (the JAX package's arithmetic and
``argpartition`` tie-break, so the two packages score one encoder's
embeddings alike), and report the fraction of queries whose gold passage
is in the top k, with a 95% Wilson interval beside it.  Chance at k=10
over 304 passages is ~0.033.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

EVAL_PATH = (Path(__file__).resolve().parents[2] / "modular_rag_system_tpu" / "assets"
             / "eval" / "external_qa.json")


def load_external_qa(path: str | None = None) -> Tuple[List[str], List[str]]:
    """Returns (queries, passages); queries[i]'s gold passage is
    passages[i]."""
    items = json.loads(Path(path or EVAL_PATH).read_text())["items"]
    return [it["query"] for it in items], [it["passage"] for it in items]


def wilson_interval(p: float, n: int, z: float = 1.96) -> Tuple[float, float]:
    """95% Wilson score interval of a binomial proportion ``p`` over ``n``
    trials; (0, 1) when ``n`` is 0."""
    if n <= 0:
        return (0.0, 1.0)
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * ((p * (1 - p) / n + z * z / (4 * n * n)) ** 0.5)
    return (max(0.0, center - half), min(1.0, center + half))


def pool_recall_at_k(encoder, queries, passages, k: int = 10) -> float:
    """recall@k of queries[i] -> passages[i] over the given pool.

    The one scoring implementation of the full-set and legacy-96 metrics.
    ``encoder`` is anything with ``encode(list[str]) -> (n, d)``; rows are
    normalised here (floor 1e-9), so encoders that do not L2-normalise are
    scored fairly."""
    D = np.asarray(encoder.encode(list(passages)), np.float32)
    Q = np.asarray(encoder.encode(list(queries)), np.float32)
    D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-9)
    Q /= np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-9)
    s = Q @ D.T
    kk = min(k, s.shape[1])
    top = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
    return float(np.mean([i in top[i] for i in range(len(queries))]))


def recall_at_k_external(encoder, k: int = 10, path: str | None = None) -> float:
    """recall@k of the gold passage over the full external set."""
    queries, passages = load_external_qa(path)
    return pool_recall_at_k(encoder, queries, passages, k)


def recall_at_k_legacy96(encoder, k: int = 10, path: str | None = None) -> float:
    """recall@k over the first 96 items as their own pool: the eval as it
    stood before it grew to 304 pairs (those items are unchanged), a fixed
    instrument across encoder versions."""
    queries, passages = load_external_qa(path)
    return pool_recall_at_k(encoder, queries[:96], passages[:96], k)


def bundled_encoder_external_recall(k: int = 10, device="cuda") -> float:
    """recall@k of the bundled checkpoint's dense encoder on ``device``
    (the JAX function's encoder: no lexical half); raises when the
    bundled assets cannot be read."""
    from modular_rag_system_tpu_torch.config import RAGConfig
    from modular_rag_system_tpu_torch.models.default_ckpt import build_default_encoder

    return recall_at_k_external(build_default_encoder(RAGConfig(), device), k=k)
