"""The plain reference of the dense encoder: a BERT-class sentence
encoder written out in float32 PyTorch operations, from the published
description (post-LN blocks, erf GELU, masked mean pooling, L2
normalisation), with no kernel, cache or batching of the program.

Weights are held under the Hugging Face BERT names.  ``bundled_weights``
reads the shipped checkpoint (``params.npz``, the flax tree) from the
bundled data files; the benchmark makes the other configuration's
weights from the seed and hands the same tensors to both sides.

``precision="fp8"`` rounds every operand and result of a matrix product
and every activation between them (LayerNorm, softmax and GELU outputs)
to float8 e4m3 (one scale a tensor, the straight-through rounding for
the backward), as a forward computed in fp8 holds them, with sums and
the pooling in f32: the control, one step of precision below the bf16
that the configurations state.  ``precision="bf16"`` rounds the same
values to bfloat16: a witness of what rounding alone does to a compared
number at the configurations' own precision.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.common import ASSETS, read_json

_ATTN = "MultiHeadDotProductAttention_0"
_E4M3_MAX = 448.0


def no_tf32() -> None:
    """True float32 products: the reference never runs in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bundled_arch() -> dict:
    return read_json(ASSETS / "default_encoder" / "arch.json")


def bundled_weights(device) -> Dict[str, torch.Tensor]:
    """The shipped encoder's f32 weights under HF names, from params.npz."""
    arch = bundled_arch()
    h = arch["hidden"]
    with np.load(ASSETS / "default_encoder" / "params.npz") as z:
        f = {k: z[k].astype(np.float32) for k in z.files}
    w = {"embeddings.word_embeddings.weight": f["tok_embed/embedding"],
         "embeddings.position_embeddings.weight": f["pos_embed/embedding"],
         "embeddings.token_type_embeddings.weight": np.zeros((2, h), np.float32),
         "embeddings.LayerNorm.weight": f["embed_ln/scale"],
         "embeddings.LayerNorm.bias": f["embed_ln/bias"]}
    for i in range(arch["num_layers"]):
        s, d = f"block_{i}", f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            k = f[f"{s}/{_ATTN}/{name}/kernel"]
            w[f"{d}.attention.self.{name}.weight"] = k.reshape(k.shape[0], -1).T
            w[f"{d}.attention.self.{name}.bias"] = f[f"{s}/{_ATTN}/{name}/bias"].reshape(-1)
        k = f[f"{s}/{_ATTN}/out/kernel"]
        w[f"{d}.attention.output.dense.weight"] = k.reshape(-1, k.shape[-1]).T
        w[f"{d}.attention.output.dense.bias"] = f[f"{s}/{_ATTN}/out/bias"]
        w[f"{d}.intermediate.dense.weight"] = f[f"{s}/Dense_0/kernel"].T
        w[f"{d}.intermediate.dense.bias"] = f[f"{s}/Dense_0/bias"]
        w[f"{d}.output.dense.weight"] = f[f"{s}/Dense_1/kernel"].T
        w[f"{d}.output.dense.bias"] = f[f"{s}/Dense_1/bias"]
        for j, ln in ((0, "attention.output.LayerNorm"), (1, "output.LayerNorm")):
            w[f"{d}.{ln}.weight"] = f[f"{s}/LayerNorm_{j}/scale"]
            w[f"{d}.{ln}.bias"] = f[f"{s}/LayerNorm_{j}/bias"]
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=device)
            for k, v in w.items()}


def random_weights(arch: dict, seed: int, device, std: float = 0.02,
                   type_vocab: int = 2) -> Dict[str, torch.Tensor]:
    """BERT's initialisation (matrices and tables normal with ``std``,
    biases 0, LayerNorm 1 and 0) under HF names, drawn on ``device`` from
    a generator seeded with ``seed``: one draw for all matrices of a
    shape, then split."""
    h, m, n = arch["hidden"], arch["mlp_dim"], arch["num_layers"]
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device) * std

    w = {"embeddings.word_embeddings.weight": normal(arch["vocab_size"], h),
         "embeddings.position_embeddings.weight": normal(arch["max_len"], h),
         "embeddings.token_type_embeddings.weight": normal(type_vocab, h)}
    square = normal(n, 4, h, h)
    inter = normal(n, m, h)
    out = normal(n, h, m)
    ones, zeros = torch.ones(h, device=device), torch.zeros(h, device=device)
    w["embeddings.LayerNorm.weight"], w["embeddings.LayerNorm.bias"] = ones, zeros
    for i in range(n):
        d = f"encoder.layer.{i}"
        for j, name in enumerate(("attention.self.query", "attention.self.key",
                                  "attention.self.value", "attention.output.dense")):
            w[f"{d}.{name}.weight"] = square[i, j]
            w[f"{d}.{name}.bias"] = zeros
        w[f"{d}.intermediate.dense.weight"] = inter[i]
        w[f"{d}.intermediate.dense.bias"] = torch.zeros(m, device=device)
        w[f"{d}.output.dense.weight"] = out[i]
        w[f"{d}.output.dense.bias"] = zeros
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            w[f"{d}.{ln}.weight"], w[f"{d}.{ln}.bias"] = ones, zeros
    return {k: v.contiguous() for k, v in w.items()}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its amax to 448), back in
    f32; the backward passes the gradient straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in f32 (straight-through backward)."""
    return x + (x.detach().to(torch.bfloat16).to(torch.float32) - x).detach()


def _r(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand or activation rounded to ``precision`` (f32: as is)."""
    if precision == "fp8":
        return _fp8(x)
    if precision == "bf16":
        return _bf16(x)
    return x


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return _r(torch.matmul(_r(a, precision), _r(b, precision)), precision)


def _linear(x, w, b, precision):
    return _r(_mm(x, w.T, precision) + _r(b, precision), precision)


def forward(w: Dict[str, torch.Tensor], arch: dict, ids: torch.Tensor,
            mask: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(B, L) ids and mask -> (B, hidden) unit rows, all in f32."""
    h, heads = arch["hidden"], arch["heads"]
    dh = h // heads
    B, L = ids.shape
    x = (w["embeddings.word_embeddings.weight"][ids]
         + w["embeddings.position_embeddings.weight"][:L][None]
         + w["embeddings.token_type_embeddings.weight"][0])
    x = _r(F.layer_norm(x, (h,), w["embeddings.LayerNorm.weight"],
                        w["embeddings.LayerNorm.bias"], 1e-12), precision)
    keep = mask.bool()[:, None, None, :]
    for i in range(arch["num_layers"]):
        p = f"encoder.layer.{i}."

        def heads_of(name):
            return _linear(x, w[p + name + ".weight"], w[p + name + ".bias"],
                           precision).view(B, L, heads, dh).transpose(1, 2)

        q, k, v = (heads_of("attention.self." + n) for n in ("query", "key", "value"))
        s = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
        s = s.masked_fill(~keep, float("-inf"))
        a = _mm(_r(torch.softmax(s, dim=-1), precision), v,
                precision).transpose(1, 2).reshape(B, L, h)
        a = _linear(a, w[p + "attention.output.dense.weight"],
                    w[p + "attention.output.dense.bias"], precision)
        x = _r(F.layer_norm(x + a, (h,), w[p + "attention.output.LayerNorm.weight"],
                            w[p + "attention.output.LayerNorm.bias"], 1e-12), precision)
        f = _r(F.gelu(_linear(x, w[p + "intermediate.dense.weight"],
                              w[p + "intermediate.dense.bias"], precision)), precision)
        f = _linear(f, w[p + "output.dense.weight"], w[p + "output.dense.bias"], precision)
        x = _r(F.layer_norm(x + f, (h,), w[p + "output.LayerNorm.weight"],
                            w[p + "output.LayerNorm.bias"], 1e-12), precision)
    m = mask.float()[..., None]
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


@torch.no_grad()
def embed(w, arch, tok, texts, device, precision: str = "f32", block: int = 256):
    """Unit rows of ``texts`` through ``forward``, ``block`` texts a call."""
    out = []
    for s in range(0, len(texts), block):
        ids, mask = tok.batch(texts[s:s + block])
        out.append(forward(w, arch, torch.from_numpy(ids).to(device),
                           torch.from_numpy(mask).to(device), precision))
    return torch.cat(out) if out else torch.zeros((0, arch["hidden"]), device=device)
