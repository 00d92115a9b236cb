"""Unified typed configuration (the same tree as the JAX package's).

One typed config tree with layered overlay semantics: dataclass
defaults -> optional JSON file -> explicit overrides (e.g. CLI flags).
Field names and defaults match ``modular_rag_system_tpu.config``, so one
config file drives either package.  ``mesh`` lays the index out: shards
over several devices (``index_shards``, ``dcn_slices``) and, with
``multihost``, across the processes of a ``torch.distributed`` gloo
group, configured through its fields or the ``RAG_*`` or torchrun
variables (``parallel/multihost.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class EmbeddingConfig:
    """Encoder + chunking knobs."""

    # "minilm"/"auto" = the bundled hybrid encoder; "fake" =
    # deterministic feature encoder (the hermetic-test backend).
    model: str = "auto"
    dim: int = 384
    max_seq_len: int = 256
    chunk_size_tokens: int = 512
    chunk_overlap_tokens: int = 50
    batch_size: int = 256
    cache_size: int = 4096
    # compute dtype of the encoder forward
    dtype: str = "bfloat16"
    # "dense" (plain tensor ops) or "flash" (the mea_attention kernel,
    # ops/flash_attention.py: no (L, L) score tensor in device memory)
    attention_impl: str = "dense"
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    vocab_size: int = 30522
    # a local HF BERT checkpoint directory (or a hub name held in an
    # offline cache) to serve before the bundled one: models/hf_loader.py
    hf_checkpoint: str = ""
    # bundled checkpoint directory: "auto" = the packaged asset
    bundled_checkpoint: str = "auto"
    # Hybrid dense+lexical embedding (models/lexical.py): when
    # lexical_dim > 0 the dense encoder is wrapped in a HybridEncoder,
    # the index dim becomes dim + lexical_dim and cosine similarity
    # decomposes as (1-w)*cos(dense) + w*cos(lexical).
    lexical_dim: int = 384
    lexical_weight: float = 0.8


@dataclass
class IndexConfig:
    """Device index knobs.

    ``tier``: "exact" (f32 matmul + top-k), "fused" (the f32/bf16
    kernels over the master), "bf16" (the same over a bf16 copy), "int8"
    (quantized index + the int8 kernels, master-exact scores), "ivf"
    (clustered ANN with an exact tail, ``ops/ivf2.py``) or "auto" (int8
    below 4,194,304 rows, ivf at and above; the write path promotes).
    ``ivf_fine_dtype``: "auto" (bf16, int8 past 4,194,304 rows), "bf16",
    "int8" or "int4" (two residual-encoded rows a byte: half the int8
    copy's bytes, candidates over-selected and rescored on the master).
    """

    tier: str = "exact"
    initial_capacity: int = 4096
    block_rows: int = 1024
    store_dtype: str = "float32"
    # optional bin-max candidate reduction width of the single-pass
    # int8 kernel; None = exact selection
    fused_bin_width: Optional[int] = None
    ivf_clusters: Optional[int] = None
    ivf_nprobe: int = 8
    ivf_iters: int = 10
    ivf_refine_extra: Optional[int] = None
    ivf_balance: float = 1.5
    ivf_fine_dtype: str = "auto"
    ivf_tail_frac: float = 0.25
    ivf_rebuild_min: int = 32768
    # search this many extra results to allow host-side metadata filtering
    overfetch: int = 4


@dataclass
class RetrievalConfig:
    max_results: int = 5
    similarity_threshold: float = 0.7
    time_weight: float = 0.1
    recent_context_size: int = 100


@dataclass
class StoreConfig:
    storage_path: str = "rag_storage"
    max_documents: int = 10_000_000
    retention_days: Optional[float] = None
    # write the index snapshot at shutdown (else restart re-embeds)
    snapshot_on_shutdown: bool = True


@dataclass
class PrivacyConfig:
    enabled: bool = True
    anonymize: bool = True
    blocked_applications: List[str] = field(
        default_factory=lambda: [
            "1password", "keepass", "bitwarden", "lastpass",
            "banking", "wallet", "signal",
        ]
    )
    blocked_window_keywords: List[str] = field(
        default_factory=lambda: ["password", "login", "sign in", "credential"]
    )


@dataclass
class ServingConfig:
    file_server_port: int = 8089
    upload_folder: str = "uploads"
    ollama_base_url: str = "http://localhost:11434"
    ollama_model: str = "llama3.2:3b"
    llm_timeout_s: float = 30.0
    response_cache_ttl_s: float = 300.0
    response_cache_max: int = 100
    query_batch_window_ms: float = 0.0
    query_batch_max: int = 256


@dataclass
class MeshConfig:
    """Sharded / multihost layout: ``index_shards > 1`` builds a
    ``ShardedIndex`` (``dcn_slices > 1``: its two-level merge).
    ``multihost`` joins a ``torch.distributed`` group (``coordinator``,
    ``num_processes``, ``process_id``, else the ``RAG_*`` or torchrun
    environment) before the engine builds its index: the slices are then
    the processes, and unset ``index_shards`` / ``dcn_slices`` default to
    the global shard count and the process count
    (``parallel/multihost.py``)."""

    index_shards: int = 1
    dcn_slices: int = 1
    index_axis: str = "index"
    data_axis: str = "data"
    model_axis: str = "model"
    multihost: bool = False
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1


@dataclass
class RAGConfig:
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    privacy: PrivacyConfig = field(default_factory=PrivacyConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------
    @classmethod
    def load(
        cls,
        path: Optional[str] = None,
        overrides: Optional[Dict[str, Any]] = None,
        write_default: bool = False,
    ) -> "RAGConfig":
        """defaults -> JSON overlay -> explicit overrides.

        ``overrides`` keys are dotted paths, e.g. ``{"index.tier": "int8"}``.
        """
        cfg = cls()
        if path is not None:
            p = Path(path)
            if p.exists():
                cfg = cfg.merged(json.loads(p.read_text()))
            elif write_default:
                p.parent.mkdir(parents=True, exist_ok=True)
                p.write_text(json.dumps(cfg.to_dict(), indent=2))
        if overrides:
            for dotted, value in overrides.items():
                cfg._set_dotted(dotted, value)
        return cfg

    def merged(self, overlay: Dict[str, Any]) -> "RAGConfig":
        """Deep-merge a nested dict of settings over this config."""
        new = RAGConfig(**{f.name: getattr(self, f.name) for f in dataclasses.fields(self)})
        for section, values in overlay.items():
            if not hasattr(new, section):
                raise KeyError(f"unknown config section: {section!r}")
            sub = getattr(new, section)
            if isinstance(values, dict):
                updated = dataclasses.replace(sub, **{
                    k: v for k, v in values.items() if hasattr(sub, k)
                })
                unknown = [k for k in values if not hasattr(sub, k)]
                if unknown:
                    raise KeyError(f"unknown keys in [{section}]: {unknown}")
                setattr(new, section, updated)
            else:
                setattr(new, section, values)
        return new

    def _set_dotted(self, dotted: str, value: Any) -> None:
        section, _, key = dotted.partition(".")
        if not key:
            raise KeyError(f"override must be 'section.key', got {dotted!r}")
        sub = getattr(self, section)
        if not hasattr(sub, key):
            raise KeyError(f"unknown config key: {dotted!r}")
        setattr(self, section, dataclasses.replace(sub, **{key: value}))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))
