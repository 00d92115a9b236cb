"""The plain reference of DeepSeek-V3 (Moonlight-16B-A3B) as a
last-token-pooled embedder: the published equations written out in
float32 PyTorch operations, with no kernel, cache or batching of the
program.

From moonshotai/Moonlight-16B-A3B's ``config.json`` (``model_type``
``deepseek_v3``), as transformers' ``modeling_deepseek_v3.py`` computes
them with ``rope_interleave`` true:

* ``embed_tokens``; layer i: ``x += o_proj(attn(input_layernorm(x)))``,
  then ``x += mlp(post_attention_layernorm(x))``; ``norm``; RMSNorm
  ``w * x / sqrt(mean(x^2) + eps)`` with ``rms_norm_eps``, but 1e-6 in
  ``kv_a_layernorm`` (transformers builds it with the default);
* MLA, no query LoRA: ``q = q_proj(h)`` (heads x [nope | rope]);
  ``[c | k_pe] = kv_a_proj_with_mqa(h)``; ``[k_nope | v] =
  kv_b_proj(kv_a_layernorm(c))`` per head; RoPE on q's rope part and on
  k_pe (shared by the heads): the pairs (2i, 2i + 1) gathered evens first,
  then ``x cos + rotate_half(x) sin`` with angles position x
  theta^(-2i / rope) in f32; ``k = [k_nope | k_pe]``; causal
  softmax(q k^T / sqrt(nope + rope)) v;
* layers below ``first_k_dense_replace``: SwiGLU ``down(silu(gate(h)) *
  up(h))`` of width ``intermediate_size``; the others: router logits ``h
  W^T`` (f32), scores sigmoid, the ``num_experts_per_tok`` largest of
  scores + ``e_score_correction_bias`` chosen, weights the chosen scores
  over their sum times ``routed_scaling_factor``; ``sum_i w_i
  expert_i(h) + shared_experts(h)`` (SwiGLUs of width
  ``moe_intermediate_size`` and that x ``n_shared_experts``);
* the embedding: ``norm``'s output at the last token, L2-normalised.

Departures from the published model, none of which changes the function
computed: each document runs alone, unpadded (no mask but the causal
one), its attention a block of ``block`` query rows at a time; the
per-token layers run on all documents' tokens at once, one layer after
the other, so that a layer's weights can be drawn, used and dropped
(``weights`` may be a function of the tensor's name); the experts are
summed in expert order.  The published weights and tokenizer are not in
the repository: ``random_weights`` draws each tensor from (seed, its
name), rounded to bf16 as the checkpoint stores it.

``follow``: the program's experts of each token in each expert layer.
A token's choice is sound when each expert the program chose lies no
further than the tie band (``tie_band``) below the reference's own k-th
largest selection score, and no expert it left out lies further than the
band above it.  The reference takes the program's choice of a sound
token, and its own of any other; ``faults`` counts the chosen experts
below the band and the left-out experts above it.  The hidden states
then measure arithmetic, not rounding flips at near-ties.

``precision="fp8"`` (the control) rounds every operand and result of a
matrix product, every activation (norm, RoPE, softmax and SwiGLU
outputs) and the residual stream after each sum to float8 e4m3,
``"bf16"`` (the witness, the configuration's precision) to bfloat16, as
the published model keeps them; the combine and the pooling stay f32.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.bert import _mm, _r, no_tf32

__all__ = ["no_tf32", "tensor_shapes", "draw", "random_weights", "tie_band", "hidden",
           "hidden_many", "forward", "embed", "routes", "ids_of"]

Weights = Union[Dict[str, torch.Tensor], Callable[[str], torch.Tensor]]

# the bf16 unit roundoff: the program rounds the router's input to bf16
_U_BF16 = 2.0 ** -8


def tensor_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of the embedder under the published
    names (``model.`` prefix, no ``lm_head``), in checkpoint order."""
    h, H, V = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, m = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    out = [("model.embed_tokens.weight", (V, h))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (h,)),
                (p + "self_attn.q_proj.weight", (H * (nope + rope), h)),
                (p + "self_attn.kv_a_proj_with_mqa.weight", (rank + rope, h)),
                (p + "self_attn.kv_a_layernorm.weight", (rank,)),
                (p + "self_attn.kv_b_proj.weight", (H * (nope + dv), rank)),
                (p + "self_attn.o_proj.weight", (h, H * dv)),
                (p + "post_attention_layernorm.weight", (h,))]
        if i < cfg["first_k_dense_replace"]:
            out += _swiglu_shapes(p + "mlp.", h, cfg["intermediate_size"])
            continue
        E = cfg["n_routed_experts"]
        out += [(p + "mlp.gate.weight", (E, h)), (p + "mlp.gate.e_score_correction_bias", (E,))]
        for e in range(E):
            out += _swiglu_shapes(p + f"mlp.experts.{e}.", h, m)
        out += _swiglu_shapes(p + "mlp.shared_experts.", h, m * cfg["n_shared_experts"])
    out.append(("model.norm.weight", (h,)))
    return out


def _swiglu_shapes(p: str, h: int, m: int):
    return [(p + "gate_proj.weight", (m, h)), (p + "up_proj.weight", (m, h)),
            (p + "down_proj.weight", (h, m))]


def _seed(seed: int, name: str) -> int:
    d = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(d[:8], "little") & ((1 << 63) - 1)


def draw(cfg: dict, seed: int, name: str, shape, device, bias_std: float = 0.05
         ) -> torch.Tensor:
    """One tensor drawn from (seed, name), f32 holding bf16 values: norms 1;
    the router's correction bias normal with ``bias_std`` (nonzero, so that
    choosing and weighting differ); every matrix normal with
    ``initializer_range`` (0.02 where the configuration does not say)."""
    if name.endswith("norm.weight"):
        return torch.ones(shape, device=device)
    g = torch.Generator(device=device).manual_seed(_seed(seed, name))
    std = (bias_std if name.endswith("e_score_correction_bias")
           else cfg.get("initializer_range", 0.02))
    t = torch.empty(shape, device=device).normal_(0.0, std, generator=g)
    return t.to(torch.bfloat16).float()


def random_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``tensor_shapes``, drawn by ``draw``."""
    return {n: draw(cfg, seed, n, s, device) for n, s in tensor_shapes(cfg)}


def _get(weights: Weights, name: str) -> torch.Tensor:
    return weights(name) if callable(weights) else weights[name]


def _rms(x, w, eps, precision):
    return _r(w * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)), precision)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleave: bool
          ) -> torch.Tensor:
    """(N, ..., d) x rotated; cos, sin (N, d)."""
    if interleave:
        x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[1],)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos.view(shape) + torch.cat((-x2, x1), dim=-1) * sin.view(shape)


def _attention(q, k, v, precision: str, block: int) -> torch.Tensor:
    """One document's (n, H, dqk) q, k and (n, H, dv) v -> (n, H dv), causal,
    ``block`` query rows at a time."""
    n, H, dqk = q.shape
    q, k, v = (x.transpose(0, 1) for x in (q, k, v))  # (H, n, d)
    pos = torch.arange(n, device=q.device)
    out = []
    for q0 in range(0, n, block):
        q1 = min(q0 + block, n)
        s = _mm(q[:, q0:q1], k[:, :q1].transpose(1, 2), precision) / math.sqrt(dqk)
        s = s.masked_fill(pos[None, :q1] > pos[q0:q1, None], float("-inf"))
        p = _r(torch.softmax(s, dim=-1), precision)
        out.append(_mm(p, v[:, :q1], precision))
    return torch.cat(out, dim=1).transpose(0, 1).reshape(n, -1)


def _swiglu(x, p: str, weights: Weights, precision: str, rows: int = 16384) -> torch.Tensor:
    """``rows`` tokens at a time: the dense layer's (N, 11,264) f32
    intermediates of 64 long documents would take tens of GB."""
    wg, wu, wd = (_get(weights, p + f"{n}_proj.weight").T for n in ("gate", "up", "down"))
    out = []
    for r0 in range(0, x.shape[0], rows):
        xr = x[r0:r0 + rows]
        g, u = _mm(xr, wg, precision), _mm(xr, wu, precision)
        out.append(_mm(_r(_r(F.silu(g), precision) * u, precision), wd, precision))
    return torch.cat(out) if len(out) != 1 else out[0]


def tie_band(a: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(N,) the band within which two experts' selection scores may swap
    order in the program by rounding alone.  The program rounds the
    router's input ``a`` to bf16, each value by at most u = 2^-8 of itself;
    by Cauchy-Schwarz that moves expert e's logit by at most u |W_e| |a|,
    its sigmoid score (slope at most 1/4) by a quarter of that, and two
    experts' scores apart by at most twice that: 0.5 u max_e |W_e| |a|."""
    return 0.5 * _U_BF16 * torch.linalg.vector_norm(gate, dim=1).max() * \
        torch.linalg.vector_norm(a, dim=1)


def _moe(a, p: str, cfg: dict, weights: Weights, precision: str, follow, stats, record):
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    gate = _get(weights, p + "mlp.gate.weight")
    bias = _get(weights, p + "mlp.gate.e_score_correction_bias")
    s = torch.sigmoid(_mm(a, gate.T, precision))
    choice = s + bias
    ranked = torch.sort(choice, dim=1, descending=True, stable=True)
    idx = ranked.indices[:, :k]
    if follow is not None:
        prog = follow.to(idx.device)
        kth = ranked.values[:, k - 1:k]
        band = tie_band(a, gate)[:, None]
        below = choice.gather(1, prog) < kth - band
        chosen = torch.zeros_like(choice, dtype=torch.bool).scatter_(1, prog, True)
        missed = (choice > kth + band) & ~chosen
        stats["faults"] += int(below.sum()) + int(missed.sum())
        stats["choices"] += below.numel()
        bad = below.any(1, keepdim=True) | missed.any(1, keepdim=True)
        idx = torch.where(bad, idx, prog)
    if record is not None:
        record.append(idx)
    w = s.gather(1, idx)
    w = w / (w.sum(dim=1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    out = torch.zeros_like(a)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(a[tok], p + f"mlp.experts.{e}.", weights, precision)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out + _swiglu(a, p + "mlp.shared_experts.", weights, precision)


@torch.no_grad()
def hidden_many(weights: Weights, cfg: dict, docs: List[torch.Tensor], precision: str = "f32",
                follow: Optional[List[List[torch.Tensor]]] = None, block: int = 1024,
                record: Optional[List[List[torch.Tensor]]] = None
                ) -> Tuple[List[torch.Tensor], Dict[str, int]]:
    """Documents' (n,) ids -> (their final hidden states (n, hidden), the
    output of ``norm``, in f32; {"faults", "choices"}).  ``follow[j][d]``:
    the program's (n, k) experts of document d in the j-th expert layer;
    ``record``, when given, gets each expert layer's list of the chosen
    (n, k) experts a document."""
    h, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    interleave = cfg.get("rope_interleave", True)
    lengths = [int(d.shape[0]) for d in docs]
    cuts = np.cumsum([0] + lengths).tolist()
    dev = docs[0].device
    ids = torch.cat(docs)
    pos = torch.cat([torch.arange(n, device=dev) for n in lengths]).float()
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, rope, 2, dtype=torch.int64, device=dev)
                                       .float() / rope))
    ang = pos[:, None] * inv[None, :]
    ang = torch.cat((ang, ang), dim=-1)
    cos, sin = ang.cos(), ang.sin()
    x = _r(_get(weights, "model.embed_tokens.weight")[ids], precision)
    N = x.shape[0]
    stats = {"faults": 0, "choices": 0}
    j = 0  # expert layers so far
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = _rms(x, _get(weights, p + "input_layernorm.weight"), eps, precision)
        q = _mm(a, _get(weights, p + "self_attn.q_proj.weight").T, precision)
        q = q.view(N, H, nope + rope)
        ckv = _mm(a, _get(weights, p + "self_attn.kv_a_proj_with_mqa.weight").T, precision)
        c = _rms(ckv[:, :rank], _get(weights, p + "self_attn.kv_a_layernorm.weight"), 1e-6,
                 precision)
        kv = _mm(c, _get(weights, p + "self_attn.kv_b_proj.weight").T, precision)
        kv = kv.view(N, H, nope + dv)
        q_pe = _r(_rope(q[..., nope:], cos, sin, interleave), precision)
        k_pe = _r(_rope(ckv[:, rank:], cos, sin, interleave), precision)
        q = torch.cat((q[..., :nope], q_pe), dim=-1)
        k = torch.cat((kv[..., :nope], k_pe[:, None, :].expand(N, H, rope)), dim=-1)
        v = kv[..., nope:]
        o = torch.cat([_attention(q[s:e], k[s:e], v[s:e], precision, block)
                       for s, e in zip(cuts[:-1], cuts[1:])])
        x = _r(x + _mm(o, _get(weights, p + "self_attn.o_proj.weight").T, precision), precision)
        a = _rms(x, _get(weights, p + "post_attention_layernorm.weight"), eps, precision)
        if i < cfg["first_k_dense_replace"]:
            x = _r(x + _swiglu(a, p + "mlp.", weights, precision), precision)
            continue
        fol = None if follow is None else torch.cat(follow[j])
        rec: Optional[list] = None if record is None else []
        x = _r(x + _r(_moe(a, p, cfg, weights, precision, fol, stats, rec), precision),
               precision)
        if record is not None:
            record.append([rec[0][s:e] for s, e in zip(cuts[:-1], cuts[1:])])
        j += 1
    x = _rms(x, _get(weights, "model.norm.weight"), eps, precision)
    return [x[s:e] for s, e in zip(cuts[:-1], cuts[1:])], stats


def hidden(weights: Weights, cfg: dict, ids: torch.Tensor, precision: str = "f32",
           block: int = 1024) -> torch.Tensor:
    """One document's (n,) ids -> its final hidden states (n, hidden)."""
    return hidden_many(weights, cfg, [ids], precision, block=block)[0][0]


def routes(weights: Weights, cfg: dict, ids: torch.Tensor) -> List[torch.Tensor]:
    """One document's (n, k) chosen experts in each expert layer, the
    reference's own choice in f32."""
    rec: List[List[torch.Tensor]] = []
    hidden_many(weights, cfg, [ids], record=rec)
    return [r[0] for r in rec]


def pooled(states: torch.Tensor) -> torch.Tensor:
    """The last token's state, L2-normalised."""
    last = states[-1]
    return last / last.norm().clamp(min=1e-12)


def forward(weights: Weights, cfg: dict, ids: torch.Tensor, precision: str = "f32",
            block: int = 1024) -> torch.Tensor:
    """One document's (n,) ids -> its (hidden,) unit row, in f32."""
    return pooled(hidden(weights, cfg, ids, precision, block))


def ids_of(tok, text: str, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(tok.ids(text), np.int64)).to(device)


@torch.no_grad()
def embed(weights: Weights, cfg: dict, tok, texts: List[str], device, precision: str = "f32",
          block: int = 1024) -> torch.Tensor:
    """Unit rows of ``texts``, all documents through each layer at once."""
    if not texts:
        return torch.zeros((0, cfg["hidden_size"]), device=device)
    states, _ = hidden_many(weights, cfg, [ids_of(tok, t, device) for t in texts], precision,
                            block=block)
    return torch.stack([pooled(s) for s in states])
