"""modular_rag_system_tpu_torch — the RAG engine on PyTorch and CUDA.

A port of ``modular_rag_system_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100.  The engine ingests and queries
through the host tokenizer, the bundled hybrid encoder, the device index
and the document store; every tier's search runs on hand-written CUDA
kernels (``kernels/``).  Above the engine sit the same host layers as in
the JAX package: the ``EnhancedRAGSystem`` facade (``facade.py``), the
HTTP query server (``serving.py``, with ``batching.py``'s query
batcher) and the launcher (``python -m
modular_rag_system_tpu_torch.launcher``).  Entry points take an explicit
``device`` and default to ``"cuda"``; without a visible card they raise
unless the caller asks for ``device="cpu"``.  This package imports neither JAX nor
the JAX package.
"""

from modular_rag_system_tpu_torch.version import __version__
from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.types import (
    Chunk,
    Document,
    EmbeddingResult,
    Query,
    RetrievalResult,
)

__all__ = ["__version__", "RAGConfig", "RAGEngine", "Document", "Query",
           "RetrievalResult", "Chunk", "EmbeddingResult", "create_engine"]


def __getattr__(name):
    if name == "RAGEngine":
        from modular_rag_system_tpu_torch.engine import RAGEngine

        return RAGEngine
    raise AttributeError(name)


def create_engine(config=None, device="cuda", index_devices=None):
    """Build a ``RAGEngine`` on ``device``; ``index_devices`` lists the
    shards' devices of a sharded index (``mesh.index_shards > 1``)."""
    from modular_rag_system_tpu_torch.engine import RAGEngine

    return RAGEngine(config, device=device, index_devices=index_devices)
