"""Deterministic fake encoder for hermetic tests.

Plays the role the reference's ``FallbackEmbedder`` played
(``embedding_pipeline.py:441-506``: 4 length stats + 42 char frequencies,
zero-padded to 384) — an always-available, dependency-free embedding
backend — but is (a) batched/vectorized and (b) actually useful for
retrieval tests: beyond character statistics it hashes word unigrams and
bigrams into the remaining dimensions, so texts sharing vocabulary land
near each other under cosine similarity.

Everything is pure numpy; no JAX required, fully deterministic.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789 .,!?"


def _stable_bucket(token: str, buckets: int) -> int:
    h = hashlib.md5(token.encode("utf-8")).digest()
    return int.from_bytes(h[:4], "little") % buckets


class FeatureHashEncoder:
    name = "feature-hash-fake"
    is_fake = True

    def __init__(self, dim: int = 384) -> None:
        if dim < len(_CHARS) + 8:
            raise ValueError("dim too small for feature layout")
        self.dim = dim
        self._n_stats = 4
        self._n_chars = len(_CHARS)
        self._hash_off = self._n_stats + self._n_chars
        self._n_hash = dim - self._hash_off

    # ------------------------------------------------------------------
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Encode a batch of texts into L2-normalized (N, dim) float32."""
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            out[i] = self._features(t)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.maximum(norms, 1e-12, out=norms)
        return out / norms

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)

    # ------------------------------------------------------------------
    def _features(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        t = text.lower()
        n = max(len(t), 1)
        words = t.split()
        # length statistics (reference kept 4 such stats)
        v[0] = min(len(t) / 1000.0, 1.0)
        v[1] = min(len(words) / 200.0, 1.0)
        v[2] = (sum(len(w) for w in words) / max(len(words), 1)) / 20.0
        v[3] = t.count(".") / n * 10.0
        # character frequencies
        for j, ch in enumerate(_CHARS):
            v[self._n_stats + j] = t.count(ch) / n
        # hashed word unigrams + bigrams — gives real lexical similarity
        for k, w in enumerate(words):
            v[self._hash_off + _stable_bucket(w, self._n_hash)] += 1.0
            if k + 1 < len(words):
                big = w + "_" + words[k + 1]
                v[self._hash_off + _stable_bucket(big, self._n_hash)] += 0.5
        return v

    def token_count(self, text: str) -> int:
        return max(1, int(len(text.split()) * 1.3))
