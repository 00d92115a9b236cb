"""Contrastive encoder fine-tuning on one device.

Symmetric InfoNCE with in-batch negatives over (query, positive) text
pairs, the JAX package's recipe step for step:

* the logits ``q_emb @ p_emb.T / temperature`` in f32 (TF32 is off on
  the card, ``utils/device.resolve_device``); the loss is the mean of
  the row-wise and column-wise cross entropies, the accuracy the share
  of rows whose argmax is their own positive;
* texts are tokenized to the full ``max_len`` with no bucket crop;
* the gradient is clipped by its global norm as optax's
  ``clip_by_global_norm`` does (scaled by ``max / norm`` only when
  ``norm >= max``), then AdamW as optax's ``adamw`` (b1 0.9, b2 0.999,
  eps 1e-8, bias-corrected moments, decay of the old parameter inside
  the update: ``p - lr * (adam + wd * p)``, on every parameter), with
  optax's ``linear_schedule(0, lr, warmup)``: lr 0 at the first step;
* the trainer owns f32 master weights, copied from the encoder's
  ``params``; the forward casts them to the encoder's compute dtype, as
  flax's ``param_dtype`` split does.

The JAX trainer's (data, model) mesh, ``param_spec`` / ``shard_params``
and the mask of the clone rows that pad a batch to the data axis are not
here: on one device a batch is never padded.  A ``flash`` encoder is
refused, as JAX cannot differentiate its Pallas kernel either.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class ContrastiveTrainer:
    """Symmetric-InfoNCE trainer on the encoder's device.

    ``sync_encoder`` publishes the trained weights to the serving
    encoder; a later trainer over the same encoder starts from them."""

    def __init__(
        self,
        encoder,
        learning_rate: float = 2e-5,
        temperature: float = 0.05,
        weight_decay: float = 0.01,
        clip_norm: float = 1.0,
        warmup_steps: int = 0,
    ) -> None:
        """``clip_norm`` global-norm gradient clipping (low-temperature
        InfoNCE scales logits by 1/temp = 20x, and unclipped early steps
        can collapse the encoder to uniform embeddings); ``warmup_steps``
        linear LR warmup from 0."""
        if encoder.module.attention_impl != "dense":
            raise ValueError(
                "ContrastiveTrainer trains only attention_impl='dense' encoders: "
                "the flash attention kernel has no backward")
        self.encoder = encoder
        self.device = encoder.device
        self.learning_rate = learning_rate
        self.temperature = temperature
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.warmup_steps = warmup_steps
        self.model = encoder.make_module(param_dtype=torch.float32)
        self.model.load_state_dict(encoder.params)
        self.model.train()
        self.params: Dict[str, torch.nn.Parameter] = dict(self.model.named_parameters())
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.step_count = 0

    # ------------------------------------------------------------------
    def _tokenize(self, texts: Sequence[str]):
        # padded to max_len, no bucket crop (the JAX trainer's shapes)
        ids, mask = self.encoder.tokenizer.encode_batch(list(texts))
        return (torch.from_numpy(ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device))

    def _loss(self, queries: Sequence[str], positives: Sequence[str]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        if len(queries) != len(positives):
            raise ValueError("queries and positives must align")
        q = self.model(*self._tokenize(queries))  # (B, d) f32
        p = self.model(*self._tokenize(positives))
        logits = (q @ p.T) / self.temperature
        labels = torch.arange(logits.shape[0], device=self.device)
        loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
        acc = (logits.argmax(dim=1) == labels).float().mean()
        return loss, acc

    def _lr(self, count: int) -> float:
        """optax ``linear_schedule(0, lr, warmup)`` at update ``count``."""
        if self.warmup_steps <= 0:
            return self.learning_rate
        frac = 1.0 - min(count, self.warmup_steps) / self.warmup_steps
        return -self.learning_rate * frac + self.learning_rate

    @torch.no_grad()
    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.clip_norm
        count = self.step_count + 1
        bc1, bc2 = 1.0 - _B1 ** count, 1.0 - _B2 ** count
        step = -self._lr(self.step_count)
        for k, p in self.params.items():
            g = torch.where(keep, grads[k], grads[k] / norm * self.clip_norm)
            mu = self.mu[k].mul_(_B1).add_((1.0 - _B1) * g)
            nu = self.nu[k].mul_(_B2).add_((1.0 - _B2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            p.add_((u + self.weight_decay * p) * step)

    def step(self, queries: Sequence[str], positives: Sequence[str]) -> Tuple[float, float]:
        """One optimization step on a batch of (query, positive) pairs;
        returns the batch's (loss, in-batch accuracy) before the update."""
        loss, acc = self._loss(queries, positives)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        self._update(dict(zip(names, grads)))
        self.step_count += 1
        return float(loss.detach()), float(acc)

    @torch.no_grad()
    def evaluate(self, queries: Sequence[str], positives: Sequence[str]
                 ) -> Tuple[float, float]:
        """(loss, in-batch accuracy) of a batch at the current weights."""
        loss, acc = self._loss(queries, positives)
        return float(loss), float(acc)

    def sync_encoder(self) -> None:
        """Publish the trained weights to the serving encoder: a new
        serving module cast from a copy of the f32 masters, swapped in
        whole (``MiniLMEncoder.publish``); the encoder's ``params`` are
        that copy."""
        self.encoder.publish({k: p.detach() for k, p in self.params.items()})

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Masters, moments and step count to one ``torch.save`` file."""
        def host(d):
            return {k: v.detach().cpu() for k, v in d.items()}

        torch.save({"params": host(self.params), "mu": host(self.mu),
                    "nu": host(self.nu), "step": self.step_count}, path)

    @torch.no_grad()
    def restore_checkpoint(self, path: str) -> None:
        state = torch.load(path, map_location=self.device, weights_only=True)
        for name, dst in (("params", self.params), ("mu", self.mu), ("nu", self.nu)):
            if set(state[name]) != set(dst):
                raise ValueError(f"checkpoint {path} does not match this encoder's {name}")
            for k, v in state[name].items():
                dst[k].copy_(v)
        self.step_count = int(state["step"])

