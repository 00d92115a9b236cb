"""ModernBERT sentence encoder in PyTorch (``modernbert-embed-base``).

The published architecture (answerdotai/ModernBERT-base ``config.json``,
arXiv:2412.13663, transformers' ``modeling_modernbert.py``), as a
sentence encoder with mean pooling:

* ``tok_embed``, then LayerNorm; there is no position table;
* pre-norm layers: ``h += wo(attn(attn_norm(h)))``, then ``h +=
  mlp(mlp_norm(h))``; layer 0 has no ``attn_norm`` (the identity);
* fused ``wqkv`` (q, k, v of every head in that order); NeoX-style
  ``rotate_half`` RoPE on q and k over the whole head;
* every ``global_every``-th layer from 0 is global: it attends to every
  key, with RoPE base ``global_theta``; the others attend only to the
  keys j with |i - j| <= ``window`` (``local_attention // 2``), with base
  ``local_theta``;
* GeGLU MLP ``wo(gelu(x1) * x2)``, ``(x1, x2) = wi(h).chunk(2)``, erf
  GELU;
* ``final_norm``; masked mean pool in f32, L2 normalisation with a
  1e-12 floor.

Norms and linear layers carry no bias (the published ``norm_bias``,
``attention_bias``, ``mlp_bias`` are false; ``hf_loader`` refuses others).

Numerics, with ``dtype`` the compute dtype (bf16 on the card):

* the residual stream stays f32: each branch's output, in the compute
  dtype, is added to it in f32;
* LayerNorms run on the f32 stream (``F.layer_norm``, two-pass variance)
  with f32 weights and round once to the compute dtype; ``final_norm``'s
  output stays f32 into the pooling;
* linear layers compute in the compute dtype (weights cast there);
* RoPE: cos and sin of the f32 angles position x inv_freq stay f32; q
  and k are widened to f32, rotated, and rounded once to the compute
  dtype;
* ``attention_impl="flash"``: global layers through ``mea_attention``,
  local layers through its window mode (``window=``), both with the
  kernel's arithmetic (f32 scores and softmax, probabilities rounded to
  the compute dtype before they multiply v, f32 sums);
* ``attention_impl="dense"``: the same arithmetic in eager tensor ops
  (``mea_attention_reference``, the kernel's plain version), for short
  inputs and the CPU.  It follows the kernel's own rule for a query row
  with no live key: in the window mode (local layers) such a row is
  zeros; in the full mode (global layers) only an all-padding batch row
  has none, and it follows the TPU kernel's rule, the mean of v over
  ``padded_length(L)`` keys.  The pooling and ``encode_device``'s
  ``[:n]`` drop such rows either way.

Each layer's attention is a tracer span, ``encoder.attn_global`` or
``encoder.attn_local``, and counts the query-key pairs it scores at the
launched shape (``encoder.attn_<kind>_pairs``: batch rows x heads x
L^2, or x the band's pairs) and its query rows x heads
(``encoder.attn_<kind>_rows``), padded keys and padded rows included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from modular_rag_system_tpu_torch.models.pooling import pool
from modular_rag_system_tpu_torch.ops.flash_attention import (
    mea_attention,
    mea_attention_reference,
)
from modular_rag_system_tpu_torch.utils.profiling import TRACER


def band_pairs(L: int, window: int) -> int:
    """The (i, j) pairs of [0, L)^2 with |i - j| <= window."""
    if window >= L - 1:
        return L * L
    return L * (2 * window + 1) - window * (window + 1)


def rope_tables(L: int, dh: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (L, dh) f32, of the angles position x inv_freq,
    inv_freq = theta^(-2i / dh), repeated over both halves of the head."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.int64, device=device)
                                .float() / dh))
    ang = torch.arange(L, device=device, dtype=torch.float32)[:, None] * inv_freq[None, :]
    ang = torch.cat((ang, ang), dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """NeoX RoPE of (B, L, ..., dh) ``x`` in f32, rounded once to x's
    dtype; cos and sin (L, dh) f32."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    shape = (1, cos.shape[0]) + (1,) * (x.dim() - 3) + (cos.shape[1],)
    return (xf * cos.view(shape) + torch.cat((-x2, x1), dim=-1) * sin.view(shape)).to(x.dtype)


class BiasFreeLayerNorm(nn.Module):
    """Bias-free LayerNorm of the f32 stream, rounded to ``dtype`` (f32:
    kept as is)."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), None,
                            self.eps).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, param_dtype: torch.dtype,
                 is_global: bool, window: int, attention_impl: str) -> None:
        super().__init__()
        self.heads, self.dh = heads, hidden // heads
        self.wqkv = nn.Linear(hidden, 3 * hidden, bias=False, dtype=param_dtype)
        self.wo = nn.Linear(hidden, hidden, bias=False, dtype=param_dtype)
        self.window = None if is_global else window
        self.kind = "global" if is_global else "local"
        self.attention_impl = attention_impl

    def forward(self, h: torch.Tensor, pad: torch.Tensor, rope) -> torch.Tensor:
        B, L, _ = h.shape
        H, dh = self.heads, self.dh
        qkv = F.linear(h, self.wqkv.weight.to(h.dtype)).view(B, L, 3, H, dh)
        qk = _rotate(qkv[:, :, :2], *rope)
        q, k, v = qk[:, :, 0], qk[:, :, 1], qkv[:, :, 2]
        if TRACER.on:
            pairs = L * L if self.window is None else band_pairs(L, self.window)
            TRACER.count(f"encoder.attn_{self.kind}_pairs", B * H * pairs)
            TRACER.count(f"encoder.attn_{self.kind}_rows", B * H * L)
        with TRACER.span(f"encoder.attn_{self.kind}"):
            if self.attention_impl == "flash":
                a = mea_attention(q, k, v, pad, self.window)
            else:
                a = mea_attention_reference(q, k, v, pad, self.window)
        return F.linear(a.reshape(B, L, H * dh), self.wo.weight.to(h.dtype))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, param_dtype: torch.dtype) -> None:
        super().__init__()
        self.wi = nn.Linear(hidden, 2 * mlp_dim, bias=False, dtype=param_dtype)
        self.wo = nn.Linear(mlp_dim, hidden, bias=False, dtype=param_dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x1, x2 = F.linear(h, self.wi.weight.to(h.dtype)).chunk(2, dim=-1)
        return F.linear(F.gelu(x1) * x2, self.wo.weight.to(h.dtype))


class Layer(nn.Module):
    def __init__(self, index: int, hidden: int, heads: int, mlp_dim: int, dtype, param_dtype,
                 global_every: int, window: int, eps: float, attention_impl: str) -> None:
        super().__init__()
        self.is_global = index % global_every == 0
        self.attn_norm = BiasFreeLayerNorm(hidden, eps, dtype) if index else None
        self.attn = Attention(hidden, heads, param_dtype, self.is_global, window, attention_impl)
        self.mlp_norm = BiasFreeLayerNorm(hidden, eps, dtype)
        self.mlp = Mlp(hidden, mlp_dim, param_dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, pad: torch.Tensor, rope) -> torch.Tensor:
        h = x.to(self.dtype) if self.attn_norm is None else self.attn_norm(x)
        x = x + self.attn(h, pad, rope).float()
        return x + self.mlp(self.mlp_norm(x)).float()


class ModernBertModule(nn.Module):
    """(ids, mask) (B, L) int -> (B, hidden) f32 unit rows.  ``dtype`` is
    the compute dtype, ``param_dtype`` that of the linear and embedding
    weights (the compute dtype unless given); norm weights stay f32.
    ``max_len`` is the longest sequence served."""

    def __init__(self, vocab_size: int = 50368, hidden: int = 768, layers: int = 22,
                 heads: int = 12, mlp_dim: int = 1152, max_len: int = 8192,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: str = "dense",
                 param_dtype: Optional[torch.dtype] = None, tp=None, global_every: int = 3,
                 window: int = 64, global_theta: float = 160000.0,
                 local_theta: float = 10000.0, eps: float = 1e-5) -> None:
        super().__init__()
        if attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"attention_impl must be 'dense' or 'flash', got {attention_impl!r}")
        if tp is not None:
            raise ValueError("ModernBertModule has no model-parallel split")
        param_dtype = param_dtype or dtype
        self.attention_impl = attention_impl
        self.dtype, self.max_len, self.dh = dtype, max_len, hidden // heads
        self.thetas = (global_theta, local_theta)
        self.tok_embed = nn.Embedding(vocab_size, hidden, dtype=param_dtype)
        self.embed_norm = BiasFreeLayerNorm(hidden, eps, dtype)
        self.blocks = nn.ModuleList(
            Layer(i, hidden, heads, mlp_dim, dtype, param_dtype, global_every, window, eps,
                  attention_impl) for i in range(layers))
        self.final_norm = BiasFreeLayerNorm(hidden, eps)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        if L > self.max_len:
            raise ValueError(f"{L} positions exceed the encoder's {self.max_len}")
        ropes = {kind: rope_tables(L, self.dh, theta, ids.device)
                 for kind, theta in zip((True, False), self.thetas)}
        x = self.embed_norm(F.embedding(ids, self.tok_embed.weight.to(self.dtype))).float()
        pad = mask.bool()
        for block in self.blocks:
            x = block(x, pad, ropes[block.is_global])
        return pool(self.final_norm(x), mask)
