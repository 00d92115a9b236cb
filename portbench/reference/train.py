"""The plain reference of the contrastive fine-tuning step, from its
description: symmetric InfoNCE with in-batch negatives over (query,
positive) pairs (logits ``q @ p.T / temperature``, the mean of the
row-wise and column-wise cross entropies), texts padded to the full
``max_len``, the gradient clipped by its global norm (scaled by ``max /
norm`` when ``norm >= max``), then AdamW (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected moments, decay ``p - lr * (adam + wd * p)`` on every
weight), all in f32 through ``bert.forward``.

The token-type table is not trained: the program's encoder folds it into
the token table and the bundled checkpoint has none.

The numbers read after three steps (the cell's file names those it
compares), each leaf of the program named by its reference leaf:

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  step's clipped gradient, over the larger of that leaf's reference norm
  and the median leaf's;
* ``change_gap``: the same for the change of the weights over the three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf that softmax makes all but
  gradient-free, as a key bias, moves under Adam by round-off alone);
* ``emb_gap``, ``emb_gap_mean``: the widest and the mean L2 distance
  between the trained module's embedding of a text of the first batch
  and the reference's, after the three steps;
* ``grad_gap_median``, ``change_gap_median``: the median leaf's gaps;
* ``grad_dir``, ``change_dir`` (and their ``_median``): the worst (the
  median) leaf's ``1 - cos`` between the program's vector and the
  reference's, over the leaves that enter ``change_gap``: a norm alone
  cannot see a gradient of the right size pointing elsewhere, and under
  Adam a change's norm is about ``lr * sqrt(n)`` whatever the gradient.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.common import log
from portbench.reference import bert

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
FROZEN = ("embeddings.token_type_embeddings.weight",)


def _loss(w, arch, tok, pairs, device, precision, temperature):
    qs, ps = zip(*pairs)
    out = []
    for texts in (qs, ps):
        ids, mask = tok.batch(list(texts), width=tok.max_len)
        out.append(bert.forward(w, arch, torch.from_numpy(ids).to(device),
                                torch.from_numpy(mask).to(device), precision))
    logits = out[0] @ out[1].T / temperature
    labels = torch.arange(len(pairs), device=device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def run(weights: Dict[str, torch.Tensor], arch: dict, tok, batches: Sequence[list], device,
        lr: float, temperature: float = 0.05, weight_decay: float = 0.01,
        clip_norm: float = 1.0, precision: str = "f32", reverse: bool = False):
    """Steps over ``batches`` from ``weights``: (losses, the first step's
    clipped gradient, the weights after the last step), each leaf f32.
    ``reverse`` plants a fault: every step takes the negated gradient."""
    w = {k: v.detach().clone().requires_grad_(k not in FROZEN) for k, v in weights.items()}
    names = [k for k in w if k not in FROZEN]
    mu = {k: torch.zeros_like(w[k]) for k in names}
    nu = {k: torch.zeros_like(w[k]) for k in names}
    losses: List[float] = []
    first = None
    for step, pairs in enumerate(batches, start=1):
        loss = _loss(w, arch, tok, pairs, device, precision, temperature)
        grads = torch.autograd.grad(loss, [w[k] for k in names])
        if reverse:
            grads = [-g for g in grads]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = clip_norm / norm if norm >= clip_norm else 1.0
            if first is None:
                log(f"reference step 1 ({precision}): loss {float(loss):.6g}, global "
                    f"gradient norm {float(norm):.6g} before the clip at {clip_norm}")
            grads = [g * scale for g in grads]
            if first is None:
                first = {k: g.clone() for k, g in zip(names, grads)}
            bc1, bc2 = 1.0 - _B1 ** step, 1.0 - _B2 ** step
            for k, g in zip(names, grads):
                mu[k].mul_(_B1).add_((1.0 - _B1) * g)
                nu[k].mul_(_B2).add_((1.0 - _B2) * g * g)
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _EPS)
                w[k] -= lr * (u + weight_decay * w[k])
    return losses, first, {k: v.detach() for k, v in w.items()}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in d.items()}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's |got - ref| over max(its ref, the median leaf's ref)."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def _dirs(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves
          ) -> Dict[str, float]:
    """Each leaf's ``1 - cos`` between ``got`` and ``ref``."""
    out = {}
    for k in leaves:
        a, b = got[k].float().reshape(-1), ref[k].float().reshape(-1)
        den = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
        out[k] = 1.0 - float(a @ b) / den if den > 0 else 1.0
    return out


def judge(prog_losses, prog_grad, prog_change, prog_emb, ref_losses, ref_grad, ref_change,
          ref_emb) -> Dict[str, float]:
    """The numbers, worst leaf and median leaf; every dict is keyed by
    reference leaf names."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog_losses, ref_losses))
    gr = _norms(ref_grad)
    grad = leaf_gaps(_norms(prog_grad), gr, list(gr))
    med = statistics.median(gr.values())
    moving = [k for k in gr if gr[k] >= 1e-3 * med]
    change = leaf_gaps(_norms(prog_change), _norms(ref_change), moving)
    gdir, cdir = _dirs(prog_grad, ref_grad, moving), _dirs(prog_change, ref_change, moving)
    g_at, c_at = max(grad, key=grad.get), max(change, key=change.get)
    pg = _norms(prog_grad)
    worst = sorted(grad, key=grad.get, reverse=True)[:3]
    log("train check: clipped first gradient, global norm program "
        f"{sum(v * v for v in pg.values()) ** 0.5:.6g}, reference "
        f"{sum(v * v for v in gr.values()) ** 0.5:.6g}; median leaf norm {med:.4g}; worst "
        "leaves (gap, program norm, reference norm): "
        + ", ".join(f"{k} {grad[k]:.3g} {pg[k]:.4g} {gr[k]:.4g}" for k in worst)
        + f"; worst direction leaves: gradient {max(gdir, key=gdir.get)} "
        f"{max(gdir.values()):.4g}, change {max(cdir, key=cdir.get)} {max(cdir.values()):.4g}")
    log(f"train check: losses {list(prog_losses)} against {list(ref_losses)}; worst "
        f"gradient leaf {g_at} {grad[g_at]:.4g}, worst change leaf {c_at} {change[c_at]:.4g}; "
        f"{len(gr) - len(moving)} leaves left out of the change: "
        f"{sorted(set(gr) - set(moving))}")
    dist = torch.linalg.vector_norm(prog_emb - ref_emb, dim=1)
    return {"loss_gap": loss_gap, "emb_gap": float(dist.max()),
            "emb_gap_mean": float(dist.mean()), "grad_gap": grad[g_at],
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap": change[c_at], "change_gap_median": statistics.median(change.values()),
            "grad_dir": max(gdir.values()), "grad_dir_median": statistics.median(gdir.values()),
            "change_dir": max(cdir.values()),
            "change_dir_median": statistics.median(cdir.values())}


def leaf_names(arch: dict) -> Dict[str, str]:
    """The program's leaf names (its encoder's state dict) -> the
    reference's."""
    out = {"tok_embed.weight": "embeddings.word_embeddings.weight",
           "pos_embed.weight": "embeddings.position_embeddings.weight",
           "embed_ln.weight": "embeddings.LayerNorm.weight",
           "embed_ln.bias": "embeddings.LayerNorm.bias"}
    parts = {"attn.query": "attention.self.query", "attn.key": "attention.self.key",
             "attn.value": "attention.self.value", "attn.out": "attention.output.dense",
             "ln0": "attention.output.LayerNorm", "ffn_in": "intermediate.dense",
             "ffn_out": "output.dense", "ln1": "output.LayerNorm"}
    for i in range(arch["num_layers"]):
        for ours, ref in parts.items():
            for p in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{p}"] = f"encoder.layer.{i}.{ref}.{p}"
    return out
