"""Encoder model family.

* ``fake.FeatureHashEncoder`` — deterministic, dependency-free encoder
  for hermetic tests.
* ``encoder.MiniLMEncoder`` with the bundled checkpoint, wrapped with the
  lexical half in a ``lexical.HybridEncoder`` — the default encoder;
  ``train.ContrastiveTrainer`` fine-tunes its dense half.  With a local
  HF checkpoint (``hf_loader``) its weights take the bundled ones' place.
* ``ollama.OllamaEmbedder`` — HTTP embeddings from an Ollama server.
"""

from modular_rag_system_tpu_torch.models.fake import FeatureHashEncoder


def build_encoder(config, device="cuda"):
    """Encoder factory honoring ``EmbeddingConfig.model``.

    ``"auto"`` and ``"minilm"`` build the dense encoder on ``device`` in
    the JAX package's order, wrapped in the hybrid encoder when
    ``lexical_dim > 0``: HF weights first (``hf_loader``: the explicit
    ``embedding.hf_checkpoint``, else an offline hub cache of
    all-MiniLM-L6-v2; nothing is downloaded), then the bundled
    checkpoint, then, when ``bundled_checkpoint`` is disabled, random
    init.  An HF checkpoint whose hidden size is not ``embedding.dim`` is
    passed over for the bundled one, as in JAX.  An explicit
    ``hf_checkpoint`` that cannot be read raises, and so does any failure
    to build the bundled checkpoint, so a broken checkpoint cannot pass
    for a working encoder.  ``"fake"`` builds the host feature-hash encoder,
    ``"ollama"`` the HTTP embedder of a running Ollama server (it raises
    when the server is unreachable)."""
    model = config.embedding.model
    if model == "fake":
        return FeatureHashEncoder(dim=config.embedding.dim)
    if model == "ollama":
        from modular_rag_system_tpu_torch.models.ollama import OllamaEmbedder

        enc = OllamaEmbedder(
            base_url=config.serving.ollama_base_url,
            dim=config.embedding.dim,
            timeout_s=config.serving.llm_timeout_s,
        )
        if not enc.available:
            raise RuntimeError(
                f"ollama server unreachable at {config.serving.ollama_base_url}")
        return enc
    if model not in ("minilm", "auto"):
        raise ValueError(f"unknown or unported encoder model {model!r}")
    emb = config.embedding
    if emb.lexical_dim > 0 and not 0.0 < emb.lexical_weight < 1.0:
        raise ValueError(
            f"embedding.lexical_weight must be in (0,1), got "
            f"{emb.lexical_weight} (use lexical_dim=0 for pure dense)")
    from modular_rag_system_tpu_torch.models.default_ckpt import build_default_encoder
    from modular_rag_system_tpu_torch.models.hf_loader import try_build_pretrained_encoder

    dense = try_build_pretrained_encoder(config, device)
    if dense is None:
        dense = build_default_encoder(config, device)
    if emb.lexical_dim <= 0:
        return dense
    from modular_rag_system_tpu_torch.models.lexical import (
        HybridEncoder,
        LexicalHashEncoder,
    )

    return HybridEncoder(dense, LexicalHashEncoder(dim=emb.lexical_dim),
                         weight=emb.lexical_weight)
