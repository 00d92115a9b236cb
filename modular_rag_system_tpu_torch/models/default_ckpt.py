"""Bundled default encoder checkpoint, read from the JAX package's assets.

The assets (``params.npz``, ``arch.json``, ``vocab.txt``, ``idf.json``,
``expansion.json``) live in ``modular_rag_system_tpu/assets/default_encoder/``
and are read here as data files through ``ASSET_DIR``; that package is
never imported.

``params.npz`` holds the flax parameter tree of the JAX
``SentenceEncoderModule``, keys joined with '/', stored as f16.
``params_from_flax`` maps that flat dict onto the state dict of the
port's ``SentenceEncoderModule`` and ``params_to_flax`` maps it back, so
the same weights drive both; ``save_default_encoder`` writes an asset
directory that either package loads.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from modular_rag_system_tpu_torch.models.tokenizer import load_vocab
from modular_rag_system_tpu_torch.models.wordpiece_train import save_vocab

ASSET_DIR = (Path(__file__).resolve().parents[2] / "modular_rag_system_tpu"
             / "assets" / "default_encoder")

_ATTN = "MultiHeadDotProductAttention_0"


def check_out_dir(out_dir) -> Path:
    """``out_dir`` as a ``Path``; refuses the JAX package's asset tree,
    which the port reads and never writes."""
    d = Path(out_dir)
    if d.resolve().is_relative_to(ASSET_DIR.parent.resolve()):
        raise ValueError(f"{d} is inside the JAX package's assets ({ASSET_DIR.parent}); "
                         "write the port's assets elsewhere")
    return d


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
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def params_to_flax(state_dict: Dict[str, torch.Tensor], heads: int
                   ) -> Dict[str, np.ndarray]:
    """``SentenceEncoderModule`` state dict -> flat '/'-joined flax params
    (f32 numpy), the inverse of ``params_from_flax``; ``heads`` splits the
    attention kernels' head axes."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    out: Dict[str, np.ndarray] = {
        "tok_embed/embedding": sd["tok_embed.weight"],
        "pos_embed/embedding": sd["pos_embed.weight"],
        "embed_ln/scale": sd["embed_ln.weight"],
        "embed_ln/bias": sd["embed_ln.bias"],
    }
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(n_layers):
        src, dst = f"blocks.{i}", f"block_{i}"
        for name in ("query", "key", "value"):
            w = sd[f"{src}.attn.{name}.weight"]  # (heads * dh, hidden)
            out[f"{dst}/{_ATTN}/{name}/kernel"] = w.T.reshape(w.shape[1], heads, -1)
            out[f"{dst}/{_ATTN}/{name}/bias"] = sd[f"{src}.attn.{name}.bias"].reshape(heads, -1)
        w = sd[f"{src}.attn.out.weight"]  # (hidden, heads * dh)
        out[f"{dst}/{_ATTN}/out/kernel"] = w.T.reshape(heads, -1, w.shape[0])
        out[f"{dst}/{_ATTN}/out/bias"] = sd[f"{src}.attn.out.bias"]
        for j, name in ((0, "ffn_in"), (1, "ffn_out")):
            out[f"{dst}/Dense_{j}/kernel"] = sd[f"{src}.{name}.weight"].T
            out[f"{dst}/Dense_{j}/bias"] = sd[f"{src}.{name}.bias"]
        for j in (0, 1):
            out[f"{dst}/LayerNorm_{j}/scale"] = sd[f"{src}.ln{j}.weight"]
            out[f"{dst}/LayerNorm_{j}/bias"] = sd[f"{src}.ln{j}.bias"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def save_default_encoder(state_dict: Dict[str, torch.Tensor], arch: dict,
                         vocab: Dict[str, int], out_dir) -> str:
    """Write the asset triplet the JAX package's ``load_default_assets``
    reads: ``params.npz`` (flax keys, f16), ``arch.json`` and
    ``vocab.txt``.  Returns the directory path."""
    d = check_out_dir(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    flat = params_to_flax(state_dict, arch["heads"])
    np.savez(d / "params.npz", **{k: v.astype(np.float16) for k, v in flat.items()})
    (d / "arch.json").write_text(json.dumps(arch, indent=1))
    save_vocab(vocab, str(d / "vocab.txt"))
    return str(d)


def build_default_encoder(config, device):
    """``MiniLMEncoder`` with the bundled trained weights; with
    ``embedding.bundled_checkpoint`` disabled (``""``), one of the
    config's architecture with random weights (seed 0), as the JAX
    package's last resort.  Raises when the checkpoint cannot serve
    ``config`` (missing, broken, or a hidden size other than
    ``embedding.dim``): a broken checkpoint does not pass for a random
    encoder."""
    from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
    from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer

    emb = config.embedding
    src = emb.bundled_checkpoint
    if not src:
        return MiniLMEncoder(
            dim=emb.dim, max_seq_len=emb.max_seq_len, batch_size=emb.batch_size,
            dtype=emb.dtype, num_layers=emb.num_layers, num_heads=emb.num_heads,
            mlp_dim=emb.mlp_dim, vocab_size=emb.vocab_size,
            attention_impl=emb.attention_impl, device=device)
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
