"""Load a local HuggingFace BERT checkpoint (the ``all-MiniLM-L6-v2`` family),
ModernBERT checkpoint (``modernbert-embed-base``) or DeepSeek-V3 checkpoint
(Moonlight-16B-A3B) into the port's encoder, without ``transformers``.

Nothing is downloaded: a checkpoint is read from a local directory
(``embedding.hf_checkpoint``) or from an offline hub cache that already
holds it.  A checkpoint directory holds

* ``config.json``: the architecture (``num_hidden_layers``,
  ``hidden_size``, ``num_attention_heads``, ``intermediate_size``,
  ``vocab_size``, ``max_position_embeddings``);
* ``vocab.txt``: the WordPiece vocab, one piece a line;
* ``model.safetensors`` (parsed here: an 8-byte little-endian header
  length, a JSON header of name -> dtype, shape and byte range, then the
  raw little-endian tensors) or else ``pytorch_model.bin``
  (``torch.load(..., weights_only=True)``).

A hub cache directory ``models--<org>--<name>`` names its current
snapshot in ``refs/main``; its files are in ``snapshots/<sha>/``.  The
cache roots are searched as ``huggingface_hub`` resolves them:
``HF_HUB_CACHE``, ``TRANSFORMERS_CACHE``, then ``HF_HOME/hub`` or
``~/.cache/huggingface/hub``.

The HF BERT names map straight onto ``SentenceEncoderModule``'s state
dict (``nn.Linear`` weights are (out, in) in both)::

  embeddings.word_embeddings (+ token_type_embeddings[0]) -> tok_embed
  embeddings.position_embeddings                        -> pos_embed
  embeddings.LayerNorm                                  -> embed_ln
  encoder.layer.N.attention.self.{query,key,value}      -> blocks.N.attn.{query,key,value}
  encoder.layer.N.attention.output.dense                -> blocks.N.attn.out
  encoder.layer.N.attention.output.LayerNorm            -> blocks.N.ln0
  encoder.layer.N.intermediate.dense                    -> blocks.N.ffn_in
  encoder.layer.N.output.dense                          -> blocks.N.ffn_out
  encoder.layer.N.output.LayerNorm                      -> blocks.N.ln1

The encoder always runs with segment id 0, so folding
``token_type_embeddings[0]`` into the word embeddings is exact.  The
weights equal the JAX package's ``load_minilm_params`` mapped through
``default_ckpt.params_from_flax``, bit for bit.

A ``config.json`` with ``model_type: "modernbert"`` loads into
``models/modernbert.py``'s ``ModernBertModule`` instead (names with or
without the ``model.`` prefix of ``ModernBertForMaskedLM``; its ``head.``
and ``decoder.`` tensors are not read)::

  embeddings.tok_embeddings   -> tok_embed
  embeddings.norm             -> embed_norm
  layers.N.attn_norm          -> blocks.N.attn_norm (none in layer 0)
  layers.N.attn.{Wqkv,Wo}     -> blocks.N.attn.{wqkv,wo}
  layers.N.mlp_norm           -> blocks.N.mlp_norm
  layers.N.mlp.{Wi,Wo}        -> blocks.N.mlp.{wi,wo}
  final_norm                  -> final_norm

It needs a ``vocab.txt`` beside it: the port has no BPE tokenizer, so the
published ``tokenizer.json`` cannot serve it.  There is no position table
to cut; the encoder serves up to ``min(embedding.max_seq_len,
max_position_embeddings)`` positions.

A ``config.json`` with ``model_type: "deepseek_v3"`` (Moonlight-16B-A3B)
loads into ``models/deepseek_v3.py``'s ``DeepseekV3Module``, streamed: the
serving module is built in the compute dtype on its device and each
tensor of ``model.safetensors`` (BF16 as published, or F32) is read from
its own byte range and copied into it, so neither host nor device holds
an f32 copy of the model (names with or without ``model.``; ``lm_head``
is not read)::

  embed_tokens                                    -> tok_embed
  layers.N.input_layernorm                        -> blocks.N.attn_norm
  layers.N.self_attn.{q_proj,kv_a_proj_with_mqa,
                      kv_a_layernorm,kv_b_proj,o_proj}
                                                  -> blocks.N.attn.{q_proj,kv_a,kv_norm,kv_b,o_proj}
  layers.N.post_attention_layernorm               -> blocks.N.mlp_norm
  layers.N.mlp.{gate,up}_proj, down_proj (dense) -> blocks.N.mlp.w13 halves, w2
  layers.N.mlp.gate.weight, .e_score_correction_bias
                                                  -> blocks.N.mlp.gate, .bias
  layers.N.mlp.experts.E.{gate,up,down}_proj      -> blocks.N.mlp.w13[E] halves, w2[E]
  layers.N.mlp.shared_experts.{gate,up,down}_proj -> blocks.N.mlp.shared.w13 halves, w2
  norm                                            -> final_norm

The loader refuses a configuration the module does not compute: a query
LoRA, RoPE scaling, grouped routing, softmax scoring, unnormalised
weights, biased attention, another activation.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from modular_rag_system_tpu_torch.models.tokenizer import load_vocab

DEFAULT_MODEL = "sentence-transformers/all-MiniLM-L6-v2"

logger = logging.getLogger(__name__)

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def iter_safetensors(path, names=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor in the file's dtype) of each tensor of a
    ``.safetensors`` file (only ``names`` when given), in the header's
    order, each read from its own byte range: at most one tensor is held
    at a time.  Raises ``ValueError`` on a malformed file or a dtype other
    than F32, F16 or BF16 among the tensors read."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header length {n} past the end of the file")
        header = json.loads(fh.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        for name, info in header.items():
            if names is not None and name not in names:
                continue
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            if end - begin != count * dtype.itemsize or base + end > size:
                raise ValueError(f"{path}: tensor {name} byte range {begin}..{end} does not "
                                 f"hold {shape} {info['dtype']}")
            # the range's own bytes: aligned, writable, owned by the tensor
            buf = bytearray(end - begin)
            fh.seek(base + begin)
            fh.readinto(buf)
            t = (torch.frombuffer(buf, dtype=dtype, count=count) if count
                 else torch.empty(0, dtype=dtype))
            yield name, t.reshape(shape)


def read_safetensors(path, names=None) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file as f32 CPU tensors (only
    ``names`` when given); raises as ``iter_safetensors`` does."""
    return {name: t.float() for name, t in iter_safetensors(path, names)}


def write_safetensors(path, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` (F32, F16 or BF16) as a ``.safetensors`` file, in
    name order, the header padded with spaces to a multiple of 8 bytes."""
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for raw in blobs:
            fh.write(raw)


def random_hf_weights(config: dict, seed: int = 0) -> Dict[str, torch.Tensor]:
    """f32 BERT weights under their HF names for ``config`` (a
    ``config.json`` dict), drawn from a ``torch.Generator`` seeded with
    ``seed`` with BERT's initialisation: matrices and embedding tables
    normal with std ``initializer_range`` (0.02), biases 0, LayerNorm
    scale 1 and bias 0."""
    g = torch.Generator().manual_seed(seed)
    std = config.get("initializer_range", 0.02)
    h, m = config["hidden_size"], config["intermediate_size"]

    def normal(*shape):
        return torch.empty(shape).normal_(0.0, std, generator=g)

    w = {"embeddings.word_embeddings.weight": normal(config["vocab_size"], h),
         "embeddings.position_embeddings.weight": normal(config["max_position_embeddings"], h),
         "embeddings.token_type_embeddings.weight": normal(config.get("type_vocab_size", 2), h)}
    linears = {"attention.self.query": (h, h), "attention.self.key": (h, h),
               "attention.self.value": (h, h), "attention.output.dense": (h, h),
               "intermediate.dense": (m, h), "output.dense": (h, m)}
    lns = ["embeddings.LayerNorm"] + [f"encoder.layer.{n}.{ln}"
                                      for n in range(config["num_hidden_layers"])
                                      for ln in ("attention.output.LayerNorm",
                                                 "output.LayerNorm")]
    for n in range(config["num_hidden_layers"]):
        for name, shape in linears.items():
            w[f"encoder.layer.{n}.{name}.weight"] = normal(*shape)
            w[f"encoder.layer.{n}.{name}.bias"] = torch.zeros(shape[0])
    for name in lns:
        w[f"{name}.weight"], w[f"{name}.bias"] = torch.ones(h), torch.zeros(h)
    return w


def save_hf_checkpoint(out_dir, weights: Dict[str, torch.Tensor], config: dict,
                       vocab: Dict[str, int]) -> Path:
    """Write a BERT checkpoint directory that ``load_minilm_params`` (and
    ``transformers``) reads: ``config.json``, ``vocab.txt`` (pieces in id
    order) and ``model.safetensors`` of ``weights`` under their HF names."""
    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(config, indent=1))
    (d / "vocab.txt").write_text("".join(p + "\n" for p, _ in
                                         sorted(vocab.items(), key=lambda kv: kv[1])))
    write_safetensors(d / "model.safetensors", weights)
    return d


def _read_weights(src: Path) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors as f32, a leading ``bert.`` dropped from
    the names (``BertFor*`` checkpoints) and old ``gamma``/``beta``
    LayerNorm names read as ``weight``/``bias``."""
    if (src / "model.safetensors").is_file():
        raw = read_safetensors(src / "model.safetensors")
    elif (src / "pytorch_model.bin").is_file():
        raw = torch.load(src / "pytorch_model.bin", map_location="cpu", weights_only=True)
        raw = {k: v.float() for k, v in raw.items() if v.is_floating_point()}
    else:
        raise FileNotFoundError(f"{src} holds neither model.safetensors nor pytorch_model.bin")
    sd = {}
    for name, t in raw.items():
        name = name.removeprefix("bert.")
        if ".LayerNorm." in name:
            name = name.replace(".gamma", ".weight").replace(".beta", ".bias")
        sd[name] = t
    return sd


def _cache_roots():
    roots = [Path(v) for v in (os.environ.get("HF_HUB_CACHE"),
                               os.environ.get("TRANSFORMERS_CACHE")) if v]
    home = os.environ.get("HF_HOME")
    roots.append(Path(home) / "hub" if home else Path.home() / ".cache" / "huggingface" / "hub")
    return roots


def _cache_dirs(model_name: str):
    """``model_name``'s hub cache directories that exist, in root order."""
    model_dir = "models--" + model_name.replace("/", "--")
    return [root / model_dir for root in _cache_roots() if (root / model_dir).is_dir()]


def _hf_cache_present(model_name: str) -> bool:
    """Whether a hub cache directory of ``model_name`` exists in any cache
    root (the JAX package's probe: existence only)."""
    return bool(_cache_dirs(model_name))


def cache_snapshot(model_name: str) -> Optional[Path]:
    """The snapshot directory that ``refs/main`` of ``model_name``'s first
    cache directory names, or None when no cache root holds the model.
    Raises ``FileNotFoundError`` when the cache directory names no
    snapshot that exists."""
    dirs = _cache_dirs(model_name)
    if not dirs:
        return None
    ref = dirs[0] / "refs" / "main"
    if not ref.is_file():
        raise FileNotFoundError(f"{dirs[0]} has no refs/main")
    snap = dirs[0] / "snapshots" / ref.read_text().strip()
    if not snap.is_dir():
        raise FileNotFoundError(f"{ref} names {snap.name}, which is not in {snap.parent}")
    return snap


def resolve_checkpoint(src: str) -> Path:
    """A checkpoint directory, or a hub model name resolved through the
    cache; raises ``FileNotFoundError`` when neither exists."""
    p = Path(src).expanduser()
    if p.is_dir():
        return p
    snap = cache_snapshot(src) if "/" in src and not p.is_absolute() else None
    if snap is None:
        raise FileNotFoundError(f"HF checkpoint {src!r} is neither a directory nor in a "
                                "hub cache")
    return snap


def load_minilm_params(model_name: str = DEFAULT_MODEL, local_dir: Optional[str] = None
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int], dict]:
    """(f32 state dict of ``SentenceEncoderModule``, vocab, arch) of the
    checkpoint in ``local_dir``, or of ``model_name`` in a hub cache.  The
    position table keeps all ``max_position_embeddings`` rows (``arch
    ["max_len"]``).  Raises when the checkpoint cannot be read or lacks a
    weight its config implies."""
    src = resolve_checkpoint(local_dir or model_name)
    cfg = json.loads((src / "config.json").read_text())
    arch = {"num_layers": cfg["num_hidden_layers"], "hidden": cfg["hidden_size"],
            "heads": cfg["num_attention_heads"], "mlp_dim": cfg["intermediate_size"],
            "vocab_size": cfg["vocab_size"], "max_len": cfg["max_position_embeddings"]}
    vocab = load_vocab(str(src / "vocab.txt"))
    if max(vocab.values()) >= arch["vocab_size"]:
        raise ValueError(f"{src}: vocab.txt has {max(vocab.values()) + 1} pieces, the "
                         f"embedding table {arch['vocab_size']} rows")
    w = _read_weights(src)
    sd = {"tok_embed.weight": w["embeddings.word_embeddings.weight"]
          + w["embeddings.token_type_embeddings.weight"][0][None, :],
          "pos_embed.weight": w["embeddings.position_embeddings.weight"],
          "embed_ln.weight": w["embeddings.LayerNorm.weight"],
          "embed_ln.bias": w["embeddings.LayerNorm.bias"]}
    names = {"attn.query": "attention.self.query", "attn.key": "attention.self.key",
             "attn.value": "attention.self.value", "attn.out": "attention.output.dense",
             "ln0": "attention.output.LayerNorm", "ffn_in": "intermediate.dense",
             "ffn_out": "output.dense", "ln1": "output.LayerNorm"}
    for n in range(arch["num_layers"]):
        for ours, theirs in names.items():
            for part in ("weight", "bias"):
                sd[f"blocks.{n}.{ours}.{part}"] = w[f"encoder.layer.{n}.{theirs}.{part}"]
    return {k: v.contiguous() for k, v in sd.items()}, vocab, arch


def _modernbert_layout(cfg: dict, src: Path) -> dict:
    """``ModernBertModule``'s keys beyond the BERT ones, from a ModernBERT
    ``config.json``; raises on what the module does not compute."""
    for key in ("norm_bias", "attention_bias", "mlp_bias"):
        if cfg.get(key, False):
            raise ValueError(f"{src}: {key} true: the port's ModernBERT layers are bias-free")
    if cfg.get("hidden_activation", "gelu") != "gelu":
        raise ValueError(f"{src}: hidden_activation {cfg['hidden_activation']!r}: the port "
                         "computes the erf GELU")
    return {"global_every": int(cfg.get("global_attn_every_n_layers", 3)),
            "window": int(cfg.get("local_attention", 128)) // 2,
            "global_theta": float(cfg.get("global_rope_theta", 160000.0)),
            "local_theta": float(cfg.get("local_rope_theta") or cfg.get("global_rope_theta",
                                                                          160000.0)),
            "eps": float(cfg.get("norm_eps", 1e-5))}


def load_modernbert_params(src: Path, cfg: dict
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int], dict]:
    """(f32 state dict of ``ModernBertModule``, vocab, arch) of the
    ModernBERT checkpoint in ``src`` whose ``config.json`` is ``cfg``;
    ``arch["layout"]`` holds the module's further keys.  Raises when the
    checkpoint cannot be read, has no ``vocab.txt``, or lacks a weight."""
    arch = {"num_layers": cfg["num_hidden_layers"], "hidden": cfg["hidden_size"],
            "heads": cfg["num_attention_heads"], "mlp_dim": cfg["intermediate_size"],
            "vocab_size": cfg["vocab_size"], "max_len": cfg["max_position_embeddings"],
            "model_type": "modernbert", "layout": _modernbert_layout(cfg, src)}
    if not (src / "vocab.txt").is_file():
        raise FileNotFoundError(f"{src} has no vocab.txt: the port serves ModernBERT with a "
                                "WordPiece vocab only (it has no BPE tokenizer)")
    vocab = load_vocab(str(src / "vocab.txt"))
    if max(vocab.values()) >= arch["vocab_size"]:
        raise ValueError(f"{src}: vocab.txt has {max(vocab.values()) + 1} pieces, the "
                         f"embedding table {arch['vocab_size']} rows")
    w = {k.removeprefix("model."): v for k, v in _read_weights(src).items()}
    sd = {"tok_embed.weight": w["embeddings.tok_embeddings.weight"],
          "embed_norm.weight": w["embeddings.norm.weight"],
          "final_norm.weight": w["final_norm.weight"]}
    names = {"attn_norm": "attn_norm", "attn.wqkv": "attn.Wqkv", "attn.wo": "attn.Wo",
             "mlp_norm": "mlp_norm", "mlp.wi": "mlp.Wi", "mlp.wo": "mlp.Wo"}
    for n in range(arch["num_layers"]):
        for ours, theirs in names.items():
            if n or ours != "attn_norm":
                sd[f"blocks.{n}.{ours}.weight"] = w[f"layers.{n}.{theirs}.weight"]
    return {k: v.contiguous() for k, v in sd.items()}, vocab, arch


def _deepseek_v3_layout(cfg: dict, src: Path) -> dict:
    """``DeepseekV3Module``'s keys beyond the BERT ones, from a DeepSeek-V3
    ``config.json``; raises on what the module does not compute."""
    refuse = {"q_lora_rank": cfg.get("q_lora_rank") is not None,
              "rope_scaling": cfg.get("rope_scaling") is not None,
              "n_group": (cfg.get("n_group") or 1) != 1,
              "topk_group": (cfg.get("topk_group") or 1) != 1,
              "scoring_func": cfg.get("scoring_func", "sigmoid") != "sigmoid",
              "topk_method": cfg.get("topk_method", "noaux_tc") != "noaux_tc",
              "norm_topk_prob": not cfg.get("norm_topk_prob", True),
              "attention_bias": bool(cfg.get("attention_bias", False)),
              "hidden_act": cfg.get("hidden_act", "silu") != "silu",
              "moe_layer_freq": cfg.get("moe_layer_freq", 1) != 1,
              "n_shared_experts": (cfg.get("n_shared_experts") or 0) < 1}
    bad = [k for k, no in refuse.items() if no]
    if bad:
        raise ValueError(f"{src}: the port's DeepSeek-V3 layers do not compute "
                         + ", ".join(f"{k}={cfg.get(k)!r}" for k in bad))
    return {"nope": int(cfg["qk_nope_head_dim"]), "rope": int(cfg["qk_rope_head_dim"]),
            "dv": int(cfg["v_head_dim"]), "kv_rank": int(cfg["kv_lora_rank"]),
            "moe_dim": int(cfg["moe_intermediate_size"]),
            "experts": int(cfg["n_routed_experts"]), "top_k": int(cfg["num_experts_per_tok"]),
            "shared": int(cfg["n_shared_experts"]),
            "first_dense": int(cfg.get("first_k_dense_replace", 0)),
            "scaling": float(cfg.get("routed_scaling_factor", 1.0)),
            "theta": float(cfg.get("rope_theta", 10000.0)),
            "eps": float(cfg.get("rms_norm_eps", 1e-6)),
            "interleave": bool(cfg.get("rope_interleave", True))}


_DSV3_ATTN = {"input_layernorm": "attn_norm", "post_attention_layernorm": "mlp_norm",
              "self_attn.q_proj": "attn.q_proj", "self_attn.kv_a_proj_with_mqa": "attn.kv_a",
              "self_attn.kv_a_layernorm": "attn.kv_norm", "self_attn.kv_b_proj": "attn.kv_b",
              "self_attn.o_proj": "attn.o_proj", "mlp.gate": "mlp.gate"}


def _deepseek_v3_target(module, name: str) -> Optional[torch.Tensor]:
    """The tensor of ``module`` that the checkpoint tensor ``name`` (no
    ``model.`` prefix) fills, or None for a name it does not compute."""
    parts = name.split(".")
    if name == "embed_tokens.weight":
        return module.tok_embed.weight
    if name == "norm.weight":
        return module.final_norm.weight
    if parts[0] != "layers" or not parts[1].isdigit() or int(parts[1]) >= len(module.blocks):
        return None
    block, rest = module.blocks[int(parts[1])], ".".join(parts[2:])
    if rest == "mlp.gate.e_score_correction_bias":
        return block.mlp.bias
    stem = rest.removesuffix(".weight")
    if stem in _DSV3_ATTN and rest.endswith(".weight"):
        try:
            return block.get_parameter(_DSV3_ATTN[stem] + ("" if stem == "mlp.gate" else ".weight"))
        except AttributeError:  # a router in a dense layer
            return None
    # SwiGLUs: gate and up are the halves of w13, down is w2
    half = {"gate_proj.weight": 0, "up_proj.weight": 1}
    mlp, leaf = block.mlp, parts[-2] + "." + parts[-1]
    if rest.startswith("mlp.experts."):
        if len(parts) != 7 or not parts[4].isdigit() or int(parts[4]) >= mlp.w13.shape[0]:
            return None
        w13, w2 = mlp.w13[int(parts[4])], mlp.w2[int(parts[4])]
    elif rest.startswith("mlp.shared_experts."):
        w13, w2 = mlp.shared.w13, mlp.shared.w2
    elif len(parts) == 5 and parts[2] == "mlp" and hasattr(mlp, "w13") and mlp.w13.dim() == 2:
        w13, w2 = mlp.w13, mlp.w2
    else:
        return None
    if leaf == "down_proj.weight":
        return w2
    if leaf in half:
        return w13.chunk(2, dim=0)[half[leaf]]
    return None


def load_deepseek_v3(src: Path, cfg: dict) -> Tuple[Callable, Dict[str, int], dict]:
    """(``fill(module)``, vocab, arch) of the DeepSeek-V3 checkpoint in
    ``src`` whose ``config.json`` is ``cfg``.  ``fill`` copies each tensor
    of ``model.safetensors`` into its place in a ``DeepseekV3Module`` (in
    the module's dtype, on its device) and raises on a tensor of another
    shape, a tensor the module does not compute, or a weight missing."""
    arch = {"num_layers": cfg["num_hidden_layers"], "hidden": cfg["hidden_size"],
            "heads": cfg["num_attention_heads"], "mlp_dim": cfg["intermediate_size"],
            "vocab_size": cfg["vocab_size"], "max_len": cfg["max_position_embeddings"],
            "model_type": "deepseek_v3", "layout": _deepseek_v3_layout(cfg, src)}
    if not (src / "vocab.txt").is_file():
        raise FileNotFoundError(f"{src} has no vocab.txt: the port serves DeepSeek-V3 with a "
                                "WordPiece vocab only (it has no BPE tokenizer)")
    if not (src / "model.safetensors").is_file():
        raise FileNotFoundError(f"{src} has no model.safetensors")
    vocab = load_vocab(str(src / "vocab.txt"))
    if max(vocab.values()) >= arch["vocab_size"]:
        raise ValueError(f"{src}: vocab.txt has {max(vocab.values()) + 1} pieces, the "
                         f"embedding table {arch['vocab_size']} rows")

    def fill(module) -> None:
        want = sum(t.numel() for t in module.state_dict().values())
        got = 0
        with torch.no_grad():
            for name, t in iter_safetensors(src / "model.safetensors"):
                name = name.removeprefix("model.")
                if name.startswith("lm_head."):
                    continue
                dst = _deepseek_v3_target(module, name)
                if dst is None:
                    raise ValueError(f"{src}: tensor {name} is not computed by the port's "
                                     "DeepSeek-V3 module")
                if tuple(t.shape) != tuple(dst.shape):
                    raise ValueError(f"{src}: tensor {name} is {tuple(t.shape)}, the module's "
                                     f"{tuple(dst.shape)}")
                dst.copy_(t)
                got += t.numel()
        if got != want:
            raise KeyError(f"{src}: the checkpoint fills {got} of the module's {want} values")

    return fill, vocab, arch


def load_checkpoint(model_name: str = DEFAULT_MODEL, local_dir: Optional[str] = None
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int], dict]:
    """(state dict, vocab, arch) of a BERT, ModernBERT or DeepSeek-V3
    checkpoint, as its ``config.json``'s ``model_type`` names it;
    ``arch["model_type"]`` is ``"bert"``, ``"modernbert"`` or
    ``"deepseek_v3"`` (whose state dict is a ``fill(module)`` function:
    ``load_deepseek_v3``)."""
    src = resolve_checkpoint(local_dir or model_name)
    cfg = json.loads((src / "config.json").read_text())
    if cfg.get("model_type") == "modernbert":
        return load_modernbert_params(src, cfg)
    if cfg.get("model_type") == "deepseek_v3":
        return load_deepseek_v3(src, cfg)
    sd, vocab, arch = load_minilm_params(local_dir=str(src))
    return sd, vocab, dict(arch, model_type="bert")


def try_build_pretrained_encoder(config, device="cuda"):
    """``MiniLMEncoder`` with HF weights on ``device``, or None.

    An explicit ``embedding.hf_checkpoint`` must load: a checkpoint that
    cannot be read raises.  Without one, the hub cache of
    ``all-MiniLM-L6-v2`` is tried, and a cache that cannot be read is
    logged and skipped (None).  A checkpoint whose hidden size is not
    ``embedding.dim`` (the index dim) cannot serve the engine: None.  The
    longest sequence served is ``min(embedding.max_seq_len,
    max_position_embeddings)``; a BERT position table is cut to it.  The
    encoder serves the module the checkpoint's ``model_type`` names."""
    from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
    from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer

    emb = config.embedding
    if emb.hf_checkpoint:
        sd, vocab, arch = load_checkpoint(local_dir=emb.hf_checkpoint)
    else:
        if not _hf_cache_present(DEFAULT_MODEL):
            return None
        try:
            sd, vocab, arch = load_checkpoint(DEFAULT_MODEL)
        except (OSError, ValueError, KeyError) as exc:
            logger.warning("hub cache of %s not usable, not loaded: %r", DEFAULT_MODEL, exc)
            return None
    if arch["hidden"] != emb.dim:
        logger.warning("HF checkpoint hidden size %d != embedding.dim %d: not served",
                       arch["hidden"], emb.dim)
        return None
    max_len = min(emb.max_seq_len, arch["max_len"])
    if arch["model_type"] == "bert":
        sd["pos_embed.weight"] = sd["pos_embed.weight"][:max_len]
    return MiniLMEncoder(
        state_dict=sd,
        dim=arch["hidden"],
        max_seq_len=max_len,
        batch_size=emb.batch_size,
        dtype=emb.dtype,
        num_layers=arch["num_layers"],
        num_heads=arch["heads"],
        mlp_dim=arch["mlp_dim"],
        vocab_size=arch["vocab_size"],
        tokenizer=WordPieceTokenizer(vocab, max_len=max_len),
        attention_impl=emb.attention_impl,
        device=device,
        model_type=arch["model_type"],
        layout=arch.get("layout"),
    )
