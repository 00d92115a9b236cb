"""MiniLM-class sentence encoder in PyTorch — the ingest and query model.

``SentenceEncoderModule`` is the JAX package's flax module of the same
name, rewritten as ``nn.Module``s with the same numerics:

* post-LN BERT blocks: residual add, then LayerNorm;
* LayerNorm computes in f32 (eps 1e-12, variance as E[x^2] - E[x]^2) and
  casts back to the compute dtype;
* parameters are kept in ``param_dtype`` and cast to the compute dtype
  where they are used (flax's ``param_dtype``/``dtype`` split): serving
  keeps them in the compute dtype, so the cast is free there, and the
  trainer keeps f32 masters;
* Dense layers compute in the compute dtype: input, weight and bias are
  all in it, and the bias is added after the product is rounded;
  embedding tables are cast before the gather;
* dense attention divides the query by sqrt(head_dim) in the compute
  dtype before the QK product, masks padded positions with
  ``finfo(dtype).min`` and runs the softmax in the compute dtype; plain
  tensor ops, since the numerics must follow the flax dense path;
* ``attention_impl="flash"`` routes the same q, k, v through
  ``ops/flash_attention.mea_attention`` (f32 scores and softmax, keys
  masked at -1e9, no (L, L) tensor in device memory): the long-context
  path, with the same parameters as the dense one;
* erf GELU; masked mean-pool in f32, then L2 normalisation with a 1e-12
  floor.

With ``tp`` (the trainer's model axis, ``models/train.py``) a module holds
one rank's part of each block, Megatron's split: its share of the heads in
q, k, v and the columns of ``out``, its share of the FFN width in
``ffn_in`` and the columns of ``ffn_out``; ``tp.enter`` marks where a
block's replicated input enters the split layers, ``tp.reduce`` sums the
ranks' partial ``out`` and ``ffn_out`` products, and the replicated bias
is added after that sum.

``MiniLMEncoder`` is the host wrapper: tokenize, crop to the pow-2
sequence bucket (min 32), pad the batch to a power of two, forward.  It
keeps the f32 weights as ``params``; without a state dict it draws them
with ``random_params`` (flax's default initialisers in distribution).
Its ``model_type`` names the module it serves: ``"bert"`` this file's
``SentenceEncoderModule``, ``"modernbert"`` ``models/modernbert.py``'s
``ModernBertModule``, ``"deepseek_v3"`` ``models/deepseek_v3.py``'s
``DeepseekV3Module`` (``layout`` holds that module's further keys).  Each
module names its pooling (``models/pooling.py``): the masked mean, or
for DeepSeek-V3 the last live token.  A state dict given as a function
(``hf_loader``'s streamed checkpoints) fills the serving module in
place, one tensor at a time, in the module's own dtype: such an encoder
keeps no f32 copy (``params`` is None) and cannot be trained.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from modular_rag_system_tpu_torch.models.deepseek_v3 import DeepseekV3Module
from modular_rag_system_tpu_torch.models.modernbert import ModernBertModule
from modular_rag_system_tpu_torch.models.pooling import pool
from modular_rag_system_tpu_torch.models.tokenizer import HashingTokenizer
from modular_rag_system_tpu_torch.ops.flash_attention import mea_attention
from modular_rag_system_tpu_torch.utils.device import resolve_device
from modular_rag_system_tpu_torch.utils.profiling import TRACER

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LayerNormF32(nn.Module):
    """flax ``LayerNorm(dtype=float32, epsilon=1e-12)``: f32 in and out."""

    def __init__(self, dim: int, eps: float = 1e-12) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def _dense(layer: nn.Linear, x: torch.Tensor, tp=None) -> torch.Tensor:
    # weights cast to the compute dtype; product rounded to it first, bias
    # added after (flax); under tp the ranks' partial products are summed
    # before the bias
    y = F.linear(x, layer.weight.to(x.dtype))
    return (y if tp is None else tp.reduce(y)) + layer.bias.to(x.dtype)


def _split(n: int, tp, what: str) -> int:
    """This rank's share of ``n`` heads or FFN units under ``tp``."""
    size = 1 if tp is None else tp.size
    if n % size:
        raise ValueError(f"{n} {what} do not split over {size} model ranks")
    return n // size


class SelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, param_dtype: torch.dtype,
                 attention_impl: str = "dense", tp=None) -> None:
        super().__init__()
        self.dh = hidden // heads
        self.heads = _split(heads, tp, "heads")  # this rank's
        self.attention_impl = attention_impl
        self.tp = tp
        width = self.heads * self.dh
        self.query = nn.Linear(hidden, width, dtype=param_dtype)
        self.key = nn.Linear(hidden, width, dtype=param_dtype)
        self.value = nn.Linear(hidden, width, dtype=param_dtype)
        self.out = nn.Linear(width, hidden, dtype=param_dtype)

    def forward(self, x: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        dh, W = self.dh, self.heads * self.dh
        if self.tp is not None:
            x = self.tp.enter(x)
        q = _dense(self.query, x).view(B, L, self.heads, dh)
        k = _dense(self.key, x).view(B, L, self.heads, dh)
        v = _dense(self.value, x).view(B, L, self.heads, dh)
        if self.attention_impl == "flash":
            # the kernel scales the f32 scores itself and masks keys only
            return _dense(self.out, mea_attention(q, k, v, pad).reshape(B, L, W), self.tp)
        q = q / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        # nn.make_attention_mask: query mask x key mask
        mask = pad[:, None, :, None] & pad[:, None, None, :]
        w = torch.where(mask, w, torch.finfo(x.dtype).min)
        # jax.nn.softmax in the compute dtype (the sum accumulates in f32)
        u = torch.exp(w - w.amax(-1, keepdim=True))
        w = u / u.sum(-1, keepdim=True, dtype=torch.float32).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, W)
        return _dense(self.out, o, self.tp)


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 param_dtype: torch.dtype, attention_impl: str = "dense", tp=None) -> None:
        super().__init__()
        self.attn = SelfAttention(hidden, heads, param_dtype, attention_impl, tp)
        self.ln0 = LayerNormF32(hidden)
        mlp = _split(mlp_dim, tp, "FFN units")
        self.ffn_in = nn.Linear(hidden, mlp, dtype=param_dtype)
        self.ffn_out = nn.Linear(mlp, hidden, dtype=param_dtype)
        self.ln1 = LayerNormF32(hidden)
        self.tp = tp

    def forward(self, x: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = self.ln0(x + self.attn(x, pad)).to(dtype)
        h = x if self.tp is None else self.tp.enter(x)
        h = _dense(self.ffn_out, F.gelu(_dense(self.ffn_in, h)), self.tp)
        return self.ln1(x + h).to(dtype)


class SentenceEncoderModule(nn.Module):
    """(ids, mask) (B, L) int -> (B, hidden) f32 unit rows.  ``dtype``
    is the compute dtype, ``param_dtype`` that of the Dense and embedding
    weights (the compute dtype unless given); LayerNorms keep f32.
    ``tp``: one model rank's part of each block (see the module doc)."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 384,
                 layers: int = 6, heads: int = 12, mlp_dim: int = 1536,
                 max_len: int = 256, dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "dense",
                 param_dtype: Optional[torch.dtype] = None, tp=None) -> None:
        super().__init__()
        if attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"attention_impl must be 'dense' or 'flash', got {attention_impl!r}")
        param_dtype = param_dtype or dtype
        self.attention_impl = attention_impl
        self.tok_embed = nn.Embedding(vocab_size, hidden, dtype=param_dtype)
        self.pos_embed = nn.Embedding(max_len, hidden, dtype=param_dtype)
        self.embed_ln = LayerNormF32(hidden)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden, heads, mlp_dim, param_dtype, attention_impl, tp)
            for _ in range(layers))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        pos = torch.arange(L, device=ids.device)[None, :]
        # flax casts each table to the compute dtype before the gather
        x = (F.embedding(ids, self.tok_embed.weight.to(self.dtype))
             + F.embedding(pos, self.pos_embed.weight.to(self.dtype)))
        x = self.embed_ln(x).to(self.dtype)
        pad = mask.bool()
        for block in self.blocks:
            x = block(x, pad)
        return pool(x, mask)


# the module each ``model_type`` serves
_MODULES = {"bert": SentenceEncoderModule, "modernbert": ModernBertModule,
            "deepseek_v3": DeepseekV3Module}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# shortest sequence bucket: seq buckets are {32, 64, ..., max_seq_len}
_MIN_SEQ_BUCKET = 32


# flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# divides the scale by that distribution's std, so the result has variance
# 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def random_params(module: SentenceEncoderModule, seed: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """f32 weights for ``module``'s state dict, drawn from a
    ``torch.Generator`` seeded with ``seed``, with flax's default
    initialisers in distribution (the values differ from flax's):
    Dense kernels lecun-normal over their fan-in, zero biases, embedding
    tables normal with variance 1 / hidden, LayerNorm scale 1, bias 0."""
    g = torch.Generator().manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, p in module.state_dict().items():
        t = torch.empty(p.shape, dtype=torch.float32)
        owner = name.split(".")[-2]
        if "ln" in owner or owner.endswith("norm"):
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("embed.weight"):
            t.normal_(0.0, math.sqrt(1.0 / p.shape[1]), generator=g)
        elif name.endswith("bias"):
            t.zero_()
        else:  # Linear weight (out, in): the fan-in is its second axis
            std = math.sqrt(1.0 / p.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
        out[name] = t
    return out


class MiniLMEncoder:
    """Host-facing wrapper: tokenize -> bucket-pad -> forward on ``device``.

    ``params`` holds the f32 weights (the module's state dict keys); the
    serving ``module`` holds them cast to the compute dtype.  A
    ``state_dict`` that is a function ``fill(module)`` loads the serving
    module in place instead, and ``params`` is None."""

    def __init__(
        self,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        dim: int = 384,
        max_seq_len: int = 256,
        batch_size: int = 256,
        dtype: str = "bfloat16",
        num_layers: int = 6,
        num_heads: int = 12,
        mlp_dim: int = 1536,
        vocab_size: int = 30522,
        tokenizer=None,
        attention_impl: str = "dense",
        device="cuda",
        seed: int = 0,
        model_type: str = "bert",
        layout: Optional[Dict] = None,
    ) -> None:
        if attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"attention_impl must be 'dense' or 'flash', got {attention_impl!r}")
        if model_type not in _MODULES:
            raise ValueError(f"model_type must be one of {sorted(_MODULES)}, got {model_type!r}")
        self.model_type = model_type
        self.device = resolve_device(device)
        self.dim = dim
        self.max_seq_len = max_seq_len
        self.batch_size = batch_size
        self.tokenizer = tokenizer or HashingTokenizer(vocab_size, max_seq_len)
        self._arch = dict(vocab_size=vocab_size, hidden=dim, layers=num_layers,
                         heads=num_heads, mlp_dim=mlp_dim, max_len=max_seq_len,
                         dtype=_DTYPES[dtype], attention_impl=attention_impl, **(layout or {}))
        if callable(state_dict):
            module = self.make_module()
            state_dict(module)
            self.params, self.module = None, module.eval()
        else:
            if state_dict is None:
                state_dict = random_params(self.make_module(), seed)
            self.publish(state_dict)
        family = "minilm" if model_type == "bert" else model_type
        self.name = f"{family}-l{num_layers}-h{dim}"

    def make_module(self, param_dtype: Optional[torch.dtype] = None, tp=None) -> nn.Module:
        """An uninitialised module of this encoder's architecture on its
        device, weights in ``param_dtype`` (default: the compute dtype);
        with ``tp``, one model rank's part of it."""
        with torch.device("meta"):
            module = _MODULES[self.model_type](**self._arch, param_dtype=param_dtype, tp=tp)
        return module.to_empty(device=self.device)

    def publish(self, params: Dict[str, torch.Tensor]) -> None:
        """Serve ``params`` (f32, keyed as the module's state dict).

        A new serving module is built, cast from ``params``, and swapped in
        by one reference assignment, so a forward in flight runs on all of
        the old weights or all of the new ones.  ``params`` is copied."""
        module = self.make_module()
        module.load_state_dict(params)
        module.eval()
        self.params = {k: v.detach().to(self.device, torch.float32, copy=True)
                       for k, v in params.items()}
        self.module = module

    # ------------------------------------------------------------------
    def _crop_seq(self, ids: np.ndarray, mask: np.ndarray):
        """Crop a (B, max_seq_len) token batch to its pow-2 seq bucket.

        Tokens are left-packed, so cropping to the longest row's bucket
        drops only all-PAD columns, which attention and pooling mask out:
        the embedding is unchanged."""
        n_tok = int(mask.sum(axis=1).max()) if mask.size else 1
        bucket = _MIN_SEQ_BUCKET
        while bucket < n_tok:
            bucket <<= 1
        bucket = min(bucket, self.max_seq_len)
        if bucket < ids.shape[1]:
            ids = ids[:, :bucket]
            mask = mask[:, :bucket]
        return ids, mask

    @torch.inference_mode()
    def forward_tokens(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Forward one tokenized (B, L) batch on the device -> (B, dim) f32."""
        return self.module(torch.from_numpy(ids).to(self.device, torch.long),
                           torch.from_numpy(mask).to(self.device))

    def encode_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Encode into a device tensor (N, dim) f32 (the bulk-ingest path:
        the rows go straight into the device index)."""
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        bs = self.batch_size
        parts = []
        for i in range(0, len(texts), bs):
            chunk = list(texts[i : i + bs])
            with TRACER.span("encoder.tokenize"):
                ids, mask = self.tokenizer.encode_batch(chunk)
                ids, mask = self._crop_seq(ids, mask)
                n = len(chunk)
                padded = min(_next_pow2(n), bs)
                if padded > n:
                    ids = np.pad(ids, ((0, padded - n), (0, 0)))
                    mask = np.pad(mask, ((0, padded - n), (0, 0)))
                if TRACER.on:
                    TRACER.count("encoder.real_tokens", int(mask.sum()))
                    TRACER.count("encoder.padded_tokens", mask.size)
            with TRACER.span("encoder.forward"):
                parts.append(self.forward_tokens(ids, mask)[:n])
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return self.encode_device(texts).cpu().numpy()

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)

    def token_count(self, text: str) -> int:
        return self.tokenizer.token_count(text)
