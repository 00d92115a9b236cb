"""modular_rag_system_tpu_torch — the RAG engine on PyTorch and CUDA.

A port of ``modular_rag_system_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100.  The engine ingests and queries
through the host tokenizer, the bundled hybrid encoder, the device index
and the document store; the int8 tier's search runs on hand-written
CUDA kernels (``kernels/``).  Entry points take an explicit ``device``
and default to ``"cuda"``; without a visible card they raise unless the
caller asks for ``device="cpu"``.  This package imports neither JAX nor
the JAX package.
"""

from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.types import Document, Query, RetrievalResult

__all__ = ["RAGConfig", "RAGEngine", "Document", "Query", "RetrievalResult",
           "create_engine"]


def __getattr__(name):
    if name == "RAGEngine":
        from modular_rag_system_tpu_torch.engine import RAGEngine

        return RAGEngine
    raise AttributeError(name)


def create_engine(config=None, device="cuda"):
    """Build a ``RAGEngine`` on ``device``."""
    from modular_rag_system_tpu_torch.engine import RAGEngine

    return RAGEngine(config, device=device)
