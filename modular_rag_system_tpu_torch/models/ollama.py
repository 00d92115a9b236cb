"""Ollama HTTP embedder — optional encoder backend.

API parity with the reference ``OllamaEmbedder``
(``embedding_pipeline.py:332-390``): ``POST {base}/api/embeddings`` with
availability probed via ``GET /api/tags``.  Unlike the reference, which
used DIFFERENT Ollama models for ingest vs query
(``nomic-embed-text`` vs ``llama3.2:3b`` — the dim-mismatch zero-recall
bug, SURVEY §2.2), one instance serves both sides here.

This backend exists for deployments that already run an Ollama server;
the default is the bundled on-device encoder (``build_encoder`` only
builds this one for ``embedding.model="ollama"``: HTTP round-trips per
batch cannot feed a device index at rate).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Sequence

import numpy as np


class OllamaEmbedder:
    is_fake = False

    def __init__(
        self,
        base_url: str = "http://localhost:11434",
        model: str = "nomic-embed-text",
        dim: int = 768,
        timeout_s: float = 30.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.dim = dim
        self.timeout_s = timeout_s
        self.name = f"ollama:{model}"
        self.available = self._probe()

    def _probe(self) -> bool:
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/api/tags", timeout=min(self.timeout_s, 2.0)
            ) as r:
                return r.status == 200
        except Exception:
            return False

    def _embed_one(self, text: str) -> np.ndarray:
        payload = json.dumps({"model": self.model, "prompt": text}).encode()
        req = urllib.request.Request(
            f"{self.base_url}/api/embeddings",
            data=payload,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            emb = np.asarray(json.loads(r.read())["embedding"], dtype=np.float32)
        if emb.shape[0] != self.dim:
            raise ValueError(
                f"ollama model {self.model} returned dim {emb.shape[0]}, "
                f"config expects {self.dim}"
            )
        return emb

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            out[i] = self._embed_one(t)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.maximum(norms, 1e-12, out=norms)
        return out / norms

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)

    def token_count(self, text: str) -> int:
        return max(1, int(len(text.split()) * 1.3))
