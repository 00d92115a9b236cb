"""The plain reference of ModernBERT as a sentence encoder
(``modernbert-embed-base``): the published equations written out in
float32 PyTorch operations, with no kernel, cache or batching of the
program.

From answerdotai/ModernBERT-base's ``config.json`` and arXiv:2412.13663,
as transformers' ``modeling_modernbert.py`` computes them:

* token embedding, then LayerNorm (no position table);
* layer i: ``x += Wo(attn(attn_norm(x)))``, then ``x += mlp(mlp_norm(x))``;
  layer 0 has no ``attn_norm``;
* ``Wqkv`` gives q, k, v of every head in that order; NeoX RoPE
  (``rotate_half``) on q and k over the whole head, angles position x
  theta^(-2j / dh) in f32;
* layers 0, n, 2n, ... (n = ``global_attn_every_n_layers``) attend to
  every key with RoPE base ``global_rope_theta``; the others to the keys
  with |i - j| <= ``local_attention`` // 2, base ``local_rope_theta``;
* softmax(q k^T / sqrt(dh)) v; MLP ``Wo(gelu(x1) * x2)``, ``(x1, x2) =
  Wi(x).chunk(2)``, erf GELU; ``final_norm``;
* mean pooling over the tokens and L2 normalisation
  (``nomic-ai/modernbert-embed-base``'s sentence-transformers head).

Departures from the published model, none of which changes the
function computed: each text runs alone, unpadded (so no key is masked
but by the band), and attention is computed a block of ``block`` query
rows at a time against the keys of their band, so that 8,192 positions
fit; dropout is left out (inference).  The published weights and BPE
tokenizer are not in the repository: the benchmark draws the weights
from the seed (``random_weights``) and tokenizes with WordPiece.

``precision="fp8"`` (the control) rounds every operand and result of a
matrix product and every activation (norm, RoPE, softmax and GLU outputs)
to float8 e4m3, ``"bf16"`` (the witness) to bfloat16, as
``reference/bert.py`` does; the residual sums and the pooling stay f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.bert import _mm, _r, no_tf32

__all__ = ["no_tf32", "random_weights", "hidden", "forward", "embed"]


def random_weights(cfg: dict, seed: int, device, std: float = 0.02) -> Dict[str, torch.Tensor]:
    """ModernBERT weights under the HF ``ModernBertModel`` names for the
    ``config.json`` dict ``cfg``: every matrix normal with ``std``,
    truncated at +-2 std, norms 1, drawn on ``device`` from a generator
    seeded with ``seed``."""
    h, m, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        t = torch.empty(shape, device=device)
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)

    ones = torch.ones(h, device=device)
    w = {"embeddings.tok_embeddings.weight": normal(cfg["vocab_size"], h),
         "embeddings.norm.weight": ones, "final_norm.weight": ones}
    for i in range(n):
        p = f"layers.{i}."
        if i:
            w[p + "attn_norm.weight"] = ones
        w[p + "attn.Wqkv.weight"] = normal(3 * h, h)
        w[p + "attn.Wo.weight"] = normal(h, h)
        w[p + "mlp_norm.weight"] = ones
        w[p + "mlp.Wi.weight"] = normal(2 * m, h)
        w[p + "mlp.Wo.weight"] = normal(h, m)
    return w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(L, H, dh) x rotated: x cos + rotate_half(x) sin."""
    L, _, dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.int64, device=x.device)
                           .float() / dh))
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    ang = torch.cat((ang, ang), dim=-1)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return x * ang.cos() + torch.cat((-x2, x1), dim=-1) * ang.sin()


def _attention(q, k, v, window: Optional[int], precision: str, block: int) -> torch.Tensor:
    """(L, H, dh) q, k, v -> (L, H * dh), ``block`` query rows at a time."""
    L, H, dh = q.shape
    q, k, v = (x.transpose(0, 1) for x in (q, k, v))  # (H, L, dh)
    pos = torch.arange(L, device=q.device)
    out = []
    for q0 in range(0, L, block):
        q1 = min(q0 + block, L)
        k0, k1 = (0, L) if window is None else (max(q0 - window, 0), min(q1 + window, L))
        s = _mm(q[:, q0:q1], k[:, k0:k1].transpose(1, 2), precision) / math.sqrt(dh)
        if window is not None:
            far = (pos[q0:q1, None] - pos[None, k0:k1]).abs() > window
            s = s.masked_fill(far, float("-inf"))
        p = _r(torch.softmax(s, dim=-1), precision)
        out.append(_mm(p, v[:, k0:k1], precision))
    return torch.cat(out, dim=1).transpose(0, 1).reshape(L, H * dh)


def _norm(x, w, eps, precision):
    return _r(F.layer_norm(x, x.shape[-1:], w, None, eps), precision)


def hidden(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
           precision: str = "f32", block: int = 1024) -> torch.Tensor:
    """One text's (L,) ids -> its final hidden states (L, hidden), the
    output of ``final_norm``, in f32."""
    h, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dh, eps = h // H, cfg["norm_eps"]
    L = ids.shape[0]
    window = cfg["local_attention"] // 2
    x = _norm(w["embeddings.tok_embeddings.weight"][ids], w["embeddings.norm.weight"], eps,
              precision)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        glob = i % cfg["global_attn_every_n_layers"] == 0
        theta = cfg["global_rope_theta"] if glob else cfg["local_rope_theta"]
        a = x if i == 0 else _norm(x, w[p + "attn_norm.weight"], eps, precision)
        qkv = _mm(a, w[p + "attn.Wqkv.weight"].T, precision).view(L, 3, H, dh)
        q, k = (_r(_rope(qkv[:, j], theta), precision) for j in (0, 1))
        a = _attention(q, k, qkv[:, 2], None if glob else window, precision, block)
        x = x + _mm(a, w[p + "attn.Wo.weight"].T, precision)
        x1, x2 = _mm(_norm(x, w[p + "mlp_norm.weight"], eps, precision),
                     w[p + "mlp.Wi.weight"].T, precision).chunk(2, dim=-1)
        f = _r(_r(F.gelu(x1), precision) * x2, precision)
        x = x + _mm(f, w[p + "mlp.Wo.weight"].T, precision)
    return _norm(x, w["final_norm.weight"], eps, precision)


def forward(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
            precision: str = "f32", block: int = 1024) -> torch.Tensor:
    """One text's (L,) ids -> its (hidden,) unit row, in f32."""
    pooled = hidden(w, cfg, ids, precision, block).mean(0)
    return pooled / pooled.norm().clamp(min=1e-12)


def ids_of(tok, text: str, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(tok.ids(text), np.int64)).to(device)


@torch.no_grad()
def embed(w, cfg: dict, tok, texts: List[str], device, precision: str = "f32",
          block: int = 1024) -> torch.Tensor:
    """Unit rows of ``texts``, one text a forward."""
    out = [forward(w, cfg, ids_of(tok, t, device), precision, block) for t in texts]
    return torch.stack(out) if out else torch.zeros((0, cfg["hidden_size"]), device=device)
