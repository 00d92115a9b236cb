"""Bundled default encoder checkpoint, read from the JAX package's assets.

The assets (``params.npz``, ``arch.json``, ``vocab.txt``, ``idf.json``,
``expansion.json``) live in ``modular_rag_system_tpu/assets/default_encoder/``
and are read here as data files through ``ASSET_DIR``; that package is
never imported.

``params.npz`` holds the flax parameter tree of the JAX
``SentenceEncoderModule``, keys joined with '/', stored as f16.
``params_from_flax`` maps that flat dict onto the state dict of the
port's ``SentenceEncoderModule``, so the same weights drive both.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from modular_rag_system_tpu_torch.models.tokenizer import load_vocab

ASSET_DIR = (Path(__file__).resolve().parents[2] / "modular_rag_system_tpu"
             / "assets" / "default_encoder")

_ATTN = "MultiHeadDotProductAttention_0"


def load_default_assets(asset_dir: Optional[str] = None
                        ) -> Tuple[Dict[str, np.ndarray], dict, Dict[str, int]]:
    """(flat f32 flax params, arch dict, vocab) of the bundled checkpoint;
    raises if an asset is missing."""
    d = Path(asset_dir) if asset_dir else ASSET_DIR
    arch = json.loads((d / "arch.json").read_text())
    with np.load(d / "params.npz") as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    return flat, arch, load_vocab(str(d / "vocab.txt"))


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat '/'-joined flax params -> ``SentenceEncoderModule`` state dict.

    Dense kernels (in, out) transpose to ``Linear.weight`` (out, in);
    attention q/k/v kernels (hidden, heads, head_dim) flatten their head
    axes before the transpose and the out kernel (heads, head_dim,
    hidden) flattens its leading axes; attention biases flatten;
    LayerNorm ``scale`` becomes ``weight``.  The flash attention path
    owns no parameters, so the same state dict loads on either
    ``attention_impl``."""
    out: Dict[str, np.ndarray] = {
        "tok_embed.weight": flat["tok_embed/embedding"],
        "pos_embed.weight": flat["pos_embed/embedding"],
        "embed_ln.weight": flat["embed_ln/scale"],
        "embed_ln.bias": flat["embed_ln/bias"],
    }
    n_layers = len({k.split("/")[0] for k in flat if k.startswith("block_")})
    for i in range(n_layers):
        src, dst = f"block_{i}", f"blocks.{i}"
        for name in ("query", "key", "value"):
            kern = flat[f"{src}/{_ATTN}/{name}/kernel"]
            out[f"{dst}.attn.{name}.weight"] = kern.reshape(kern.shape[0], -1).T
            out[f"{dst}.attn.{name}.bias"] = flat[f"{src}/{_ATTN}/{name}/bias"].reshape(-1)
        kern = flat[f"{src}/{_ATTN}/out/kernel"]
        out[f"{dst}.attn.out.weight"] = kern.reshape(-1, kern.shape[-1]).T
        out[f"{dst}.attn.out.bias"] = flat[f"{src}/{_ATTN}/out/bias"]
        for j, name in ((0, "ffn_in"), (1, "ffn_out")):
            out[f"{dst}.{name}.weight"] = flat[f"{src}/Dense_{j}/kernel"].T
            out[f"{dst}.{name}.bias"] = flat[f"{src}/Dense_{j}/bias"]
        for j in (0, 1):
            out[f"{dst}.ln{j}.weight"] = flat[f"{src}/LayerNorm_{j}/scale"]
            out[f"{dst}.ln{j}.bias"] = flat[f"{src}/LayerNorm_{j}/bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def build_default_encoder(config, device):
    """``MiniLMEncoder`` with the bundled trained weights.  Raises when
    the checkpoint cannot serve ``config`` (disabled, or a hidden size
    other than ``embedding.dim``): random initialisation is not ported."""
    from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
    from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer

    src = config.embedding.bundled_checkpoint
    if not src:
        raise ValueError("embedding.bundled_checkpoint is disabled and "
                         "random initialisation is not ported")
    flat, arch, vocab = load_default_assets(None if src == "auto" else src)
    if arch["hidden"] != config.embedding.dim:
        raise ValueError(f"bundled checkpoint hidden size {arch['hidden']} "
                         f"!= embedding.dim {config.embedding.dim}")
    max_len = min(config.embedding.max_seq_len, arch["max_len"])
    # the position table is sized max_len: rows past it are never indexed
    flat["pos_embed/embedding"] = flat["pos_embed/embedding"][:max_len]
    enc = MiniLMEncoder(
        dim=arch["hidden"],
        max_seq_len=max_len,
        batch_size=config.embedding.batch_size,
        dtype=config.embedding.dtype,
        num_layers=arch["num_layers"],
        num_heads=arch["heads"],
        mlp_dim=arch["mlp_dim"],
        vocab_size=arch["vocab_size"],
        tokenizer=WordPieceTokenizer(vocab, max_len=max_len),
        state_dict=params_from_flax(flat),
        attention_impl=config.embedding.attention_impl,
        device=device,
    )
    enc.name = f"minilm-l{arch['num_layers']}-h{arch['hidden']}-bundled"
    return enc
