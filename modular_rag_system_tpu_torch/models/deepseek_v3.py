"""DeepSeek-V3 blocks in PyTorch as a last-token-pooled sentence encoder
(Moonlight-16B-A3B: ``moonshotai/Moonlight-16B-A3B``, ``model_type``
``deepseek_v3``).

The published architecture (transformers' ``modeling_deepseek_v3.py``,
``rope_interleave`` true), as an embedder in the e5-mistral /
Qwen3-Embedding recipe:

* ``tok_embed``; pre-norm layers ``x += attn(attn_norm(x))``, then ``x +=
  mlp(mlp_norm(x))``; RMSNorm (eps ``rms_norm_eps``, but 1e-6 in ``kv_norm``,
  as transformers builds it); ``final_norm``; the final state of the last
  live token, L2-normalised (``pooling = "last"``);
* MLA without a query LoRA: ``q = q_proj(h)`` per head ``[q_nope | q_pe]``;
  ``[c | k_pe] = kv_a(h)``; per head ``[k_nope | v] = kv_b(kv_norm(c))``;
  RoPE on q_pe and on k_pe (one for all heads) in the interleaved layout
  (each pair (2i, 2i + 1) rotated by position x theta^(-2i / d_rope), the
  rotated dims gathered evens first, as transformers does); ``k = [k_nope
  | k_pe]``; causal softmax(q k^T / sqrt(d_qk)) v; ``o_proj``;
* layers before ``first_dense`` run a SwiGLU ``down(silu(gate(h)) *
  up(h))``; the others the expert layer: router logits ``h W_g^T`` in f32,
  scores ``sigmoid``, the ``top_k`` largest of scores + ``bias`` chosen
  (ties to the smaller expert id), weights the chosen scores (without the
  bias) over their sum times ``scaling``; out = sum_i w_i SwiGLU_i(h) +
  the shared experts' SwiGLU (one of width ``moe_dim`` x ``shared``).

Only live tokens run: the embedding gathers the mask's tokens into one
packed (N, hidden) stream, every per-token layer (norms, projections,
router, experts) runs on it, and attention scatters q, k and v into the
(B, L) layout ``mea_attention`` takes and gathers its live rows back.  No
padding row is routed, no expert has a capacity, no token is dropped.
The expert layer sorts the (token, expert) pairs by expert (a stable
sort: within an expert in token order), takes the experts' row offsets
as a prefix sum on the device (nothing is read back to the host), runs
every expert's SwiGLU on its contiguous rows in two grouped calls
(``ops/moe_grouped.py``: the gate/up product with the SwiGLU, then the
down product, which puts each row back at its pair) and sums a token's
six rows with their weights in f32, slot by slot.  The dense SwiGLUs (the
first layer's and the shared experts') take the same two calls, one
group each.

Numerics, with ``dtype`` the compute dtype (bf16 on the card):

* the residual stream is in the compute dtype, as the published model
  keeps it: each branch's output is added to it there;
* RMSNorms run on f32 (variance of the f32 values, f32 weights) and round
  once to the compute dtype (``final_norm``: stays f32 into the pooling);
* linear layers and expert GEMMs compute in the compute dtype (f32
  accumulation), outputs rounded to it; SwiGLU's ``silu(g) * u`` in f32,
  rounded once;
* the router's logits are f32 products of the f32 weights with the
  rounded normed input; scores, choice and weights in f32; the combine
  sums the shared experts' output and the weighted routed rows in f32 and
  rounds once;
* RoPE: cos and sin of the f32 angles stay f32, q_pe and k_pe are widened
  to f32, rotated, rounded once;
* attention through ``mea_attention``'s causal mode (f32 scores and
  softmax, probabilities rounded to the compute dtype before they multiply
  v, f32 sums) on the card, its plain version on the CPU or with
  ``attention_impl="dense"``.

Tracer: spans ``encoder.attn_causal`` (the attention call),
``encoder.moe_route`` (router, top-k, the sort, gather and offsets, the
combine) and ``encoder.moe_experts`` (the routed and shared GEMMs; no span
waits for the device); counters ``encoder.attn_causal_pairs`` (the live
causal pairs, the sum of n (n + 1) / 2 over the documents, x heads),
``encoder.attn_causal_rows`` (live query rows x heads),
``encoder.moe_rows`` (live tokens entering an expert layer),
``encoder.moe_pairs`` ((token, expert) rows the routed GEMMs computed) and
``encoder.moe_grouped_rows`` (rows the grouped SwiGLU calls computed: the
routed pairs, the shared experts' and the dense layers' rows), each
summed over layers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from modular_rag_system_tpu_torch.models.pooling import pool
from modular_rag_system_tpu_torch.ops import moe_grouped
from modular_rag_system_tpu_torch.ops.flash_attention import (
    mea_attention,
    mea_attention_reference,
)
from modular_rag_system_tpu_torch.utils.profiling import TRACER


def rope_tables(pos: torch.Tensor, dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (N, dim) f32, of the angles pos x inv_freq,
    inv_freq = theta^(-2i / dim), repeated over both halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=pos.device)
                                .float() / dim))
    ang = pos.float()[:, None] * inv_freq[None, :]
    ang = torch.cat((ang, ang), dim=-1)
    return ang.cos(), ang.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           interleave: bool = True) -> torch.Tensor:
    """RoPE of (N, ..., d) ``x`` in f32, rounded once to x's dtype; cos and
    sin (N, d).  ``interleave``: the pairs (2i, 2i + 1) are gathered evens
    first before the half rotation (transformers' layout)."""
    xf = x.float()
    if interleave:
        xf = xf.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = xf.chunk(2, dim=-1)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[1],)
    rot = torch.cat((-x2, x1), dim=-1)
    return (xf * cos.view(shape) + rot * sin.view(shape)).to(x.dtype)


def route(logits: torch.Tensor, bias: torch.Tensor, top_k: int, scaling: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, E) f32 router logits -> (experts (N, k) int64, weights (N, k)
    f32): sigmoid scores; the k largest of scores + bias, ties to the
    smaller id (a stable sort); the chosen scores over their sum, times
    ``scaling``."""
    s = torch.sigmoid(logits)
    idx = torch.sort(s + bias, dim=1, descending=True, stable=True).indices[:, :top_k]
    w = s.gather(1, idx)
    return idx, w / (w.sum(dim=1, keepdim=True) + 1e-20) * scaling


class RMSNorm(nn.Module):
    """RMSNorm of the f32 values, f32 weight, rounded to ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * x).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, nope: int, rope: int, dv: int, rank: int,
                 dtype, param_dtype, attention_impl: str) -> None:
        super().__init__()
        self.heads, self.nope, self.rope, self.dv, self.rank = heads, nope, rope, dv, rank
        self.q_proj = nn.Linear(hidden, heads * (nope + rope), bias=False, dtype=param_dtype)
        self.kv_a = nn.Linear(hidden, rank + rope, bias=False, dtype=param_dtype)
        # transformers builds kv_a_layernorm with RMSNorm's default eps,
        # 1e-6, not rms_norm_eps
        self.kv_norm = RMSNorm(rank, 1e-6, dtype)
        self.kv_b = nn.Linear(rank, heads * (nope + dv), bias=False, dtype=param_dtype)
        self.o_proj = nn.Linear(heads * dv, hidden, bias=False, dtype=param_dtype)
        self.attention_impl = attention_impl

    def forward(self, h: torch.Tensor, ctx: "_Packed") -> torch.Tensor:
        N, H = h.shape[0], self.heads
        dt = h.dtype
        q = F.linear(h, self.q_proj.weight.to(dt)).view(N, H, self.nope + self.rope)
        q[..., self.nope:] = rotate(q[..., self.nope:], *ctx.rope, ctx.interleave)
        ckv = F.linear(h, self.kv_a.weight.to(dt))
        k_pe = rotate(ckv[:, self.rank:], *ctx.rope, ctx.interleave)
        kv = F.linear(self.kv_norm(ckv[:, :self.rank]), self.kv_b.weight.to(dt))
        kv = kv.view(N, H, self.nope + self.dv)
        k = torch.cat((kv[..., :self.nope], k_pe[:, None, :].expand(N, H, self.rope)), dim=-1)
        qs, ks, vs = ctx.scatter("q", q), ctx.scatter("k", k), ctx.scatter("v", kv[..., self.nope:])
        if TRACER.on:
            TRACER.count("encoder.attn_causal_pairs", ctx.causal_pairs * H)
            TRACER.count("encoder.attn_causal_rows", N * H)
        with TRACER.span("encoder.attn_causal"):
            if self.attention_impl == "flash":
                a = mea_attention(qs, ks, vs, ctx.mask, causal=True)
            else:
                a = mea_attention_reference(qs, ks, vs, ctx.mask, causal=True)
        return F.linear(ctx.gather(a), self.o_proj.weight.to(dt))


class Mlp(nn.Module):
    """SwiGLU of width ``dim`` (the dense layers and the shared experts)."""

    def __init__(self, hidden: int, dim: int, param_dtype) -> None:
        super().__init__()
        self.w13 = nn.Parameter(torch.empty(2 * dim, hidden, dtype=param_dtype))
        self.w2 = nn.Parameter(torch.empty(hidden, dim, dtype=param_dtype))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if TRACER.on:
            TRACER.count("encoder.moe_grouped_rows", h.shape[0])
        return moe_grouped.down(moe_grouped.gate_up(h, self.w13), self.w2)


class Experts(nn.Module):
    """The expert layer: ``experts`` routed SwiGLUs of width ``dim``, stacked
    (``w13`` (E, 2 dim, hidden), ``w2`` (E, hidden, dim)), the router and
    the shared experts."""

    def __init__(self, hidden: int, dim: int, experts: int, top_k: int, shared: int,
                 scaling: float, param_dtype) -> None:
        super().__init__()
        self.gate = nn.Parameter(torch.empty(experts, hidden, dtype=param_dtype))
        self.register_buffer("bias", torch.zeros(experts, dtype=torch.float32))
        self.w13 = nn.Parameter(torch.empty(experts, 2 * dim, hidden, dtype=param_dtype))
        self.w2 = nn.Parameter(torch.empty(experts, hidden, dim, dtype=param_dtype))
        self.shared = Mlp(hidden, dim * shared, param_dtype)
        self.experts, self.top_k, self.scaling = experts, top_k, scaling

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        N, E, k = h.shape[0], self.experts, self.top_k
        dt = h.dtype
        with TRACER.span("encoder.moe_route"):
            logits = F.linear(h.float(), self.gate.float())
            idx, w = route(logits, self.bias, k, self.scaling)
            flat = idx.reshape(-1)
            order = torch.sort(flat, stable=True).indices  # pairs by expert, then token
            rows = h[order // k]
            # the experts' row offsets on the device: not torch.bincount or
            # a read of the counts, which wait for the card
            counts = torch.zeros(E, dtype=flat.dtype, device=flat.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            offsets = torch.zeros(E + 1, dtype=torch.int32, device=flat.device)
            offsets[1:] = counts.cumsum(0)
        if TRACER.on:
            TRACER.count("encoder.moe_rows", N)
            TRACER.count("encoder.moe_pairs", N * k)
            TRACER.count("encoder.moe_grouped_rows", N * k)
        with TRACER.span("encoder.moe_experts"):
            # each pair's row lands at its (token, slot) place
            by_pair = moe_grouped.down(moe_grouped.gate_up(rows, self.w13, offsets), self.w2,
                                       offsets, dest=order)
            out = self.shared(h).float()
        with TRACER.span("encoder.moe_route"):
            by_pair = by_pair.view(N, k, -1)
            for j in range(k):
                out += w[:, j:j + 1] * by_pair[:, j].float()
        return out.to(dt)


class Layer(nn.Module):
    def __init__(self, index: int, hidden: int, heads: int, mlp_dim: int, dtype, param_dtype,
                 attention_impl: str, nope: int, rope: int, dv: int, kv_rank: int,
                 moe_dim: int, experts: int, top_k: int, shared: int, first_dense: int,
                 scaling: float, eps: float) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(hidden, eps, dtype)
        self.attn = Attention(hidden, heads, nope, rope, dv, kv_rank, dtype, param_dtype,
                              attention_impl)
        self.mlp_norm = RMSNorm(hidden, eps, dtype)
        self.mlp = (Mlp(hidden, mlp_dim, param_dtype) if index < first_dense else
                    Experts(hidden, moe_dim, experts, top_k, shared, scaling, param_dtype))

    def forward(self, x: torch.Tensor, ctx: "_Packed") -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), ctx)
        return x + self.mlp(self.mlp_norm(x))


class _Packed:
    """A batch's live tokens: their flat (B L) positions, their RoPE
    tables, the scatter into and gather from the (B, L, H, d) layout
    attention takes, and the live causal pairs."""

    def __init__(self, mask: torch.Tensor, rope_dim: int, theta: float,
                 interleave: bool) -> None:
        B, L = mask.shape
        self.mask, self.shape = mask, (B, L)
        live = mask.bool().reshape(-1)
        self.at = live.nonzero().squeeze(1)
        pos = torch.arange(L, device=mask.device).repeat(B)[self.at]
        self.rope = rope_tables(pos, rope_dim, theta)
        self.interleave = interleave
        self._bufs = {}
        self.causal_pairs = 0
        if TRACER.on:
            n = mask.bool().sum(1).tolist()
            self.causal_pairs = sum(m * (m + 1) // 2 for m in n)

    def scatter(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """(N, H, d) -> (B, L, H, d), zeros at padded positions, in the
        buffer ``name`` of this batch (zeroed once, its live rows rewritten
        by each layer)."""
        B, L = self.shape
        out = self._bufs.get(name)
        if out is None:
            out = self._bufs[name] = x.new_zeros((B * L,) + tuple(x.shape[1:]))
        out.index_copy_(0, self.at, x)
        return out.view((B, L) + tuple(x.shape[1:]))

    def gather(self, a: torch.Tensor) -> torch.Tensor:
        """(B, L, H, d) -> (N, H d)."""
        return a.reshape(a.shape[0] * a.shape[1], -1)[self.at]


class DeepseekV3Module(nn.Module):
    """(ids, mask) (B, L) int -> (B, hidden) f32 unit rows, pooled at the
    last live token.  ``dtype`` is the compute dtype, ``param_dtype`` that
    of the linear, expert and embedding weights (the compute dtype unless
    given); norm weights and the router's bias stay f32."""

    pooling = "last"

    def __init__(self, vocab_size: int = 163840, hidden: int = 2048, layers: int = 27,
                 heads: int = 16, mlp_dim: int = 11264, max_len: int = 8192,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: str = "dense",
                 param_dtype: Optional[torch.dtype] = None, tp=None, nope: int = 128,
                 rope: int = 64, dv: int = 128, kv_rank: int = 512, moe_dim: int = 1408,
                 experts: int = 64, top_k: int = 6, shared: int = 2, first_dense: int = 1,
                 scaling: float = 2.446, theta: float = 50000.0, eps: float = 1e-5,
                 interleave: bool = True) -> None:
        super().__init__()
        if attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"attention_impl must be 'dense' or 'flash', got {attention_impl!r}")
        if tp is not None:
            raise ValueError("DeepseekV3Module has no model-parallel split")
        param_dtype = param_dtype or dtype
        self.dtype, self.max_len = dtype, max_len
        self.rope_dim, self.theta, self.interleave = rope, theta, interleave
        self.tok_embed = nn.Embedding(vocab_size, hidden, dtype=param_dtype)
        self.blocks = nn.ModuleList(
            Layer(i, hidden, heads, mlp_dim, dtype, param_dtype, attention_impl, nope, rope, dv,
                  kv_rank, moe_dim, experts, top_k, shared, first_dense, scaling, eps)
            for i in range(layers))
        self.final_norm = RMSNorm(hidden, eps)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L = ids.shape
        if L > self.max_len:
            raise ValueError(f"{L} positions exceed the encoder's {self.max_len}")
        ctx = _Packed(mask, self.rope_dim, self.theta, self.interleave)
        x = F.embedding(ids.reshape(-1)[ctx.at], self.tok_embed.weight.to(self.dtype))
        for block in self.blocks:
            x = block(x, ctx)
        x = self.final_norm(x)
        full = x.new_zeros((B * L, x.shape[1]))
        full.index_copy_(0, ctx.at, x)
        return pool(full.view(B, L, -1), mask, self.pooling)
