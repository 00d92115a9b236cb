"""Contrastive encoder fine-tuning, on one device or over a (data, model)
layout of ranks.

Symmetric InfoNCE with in-batch negatives over (query, positive) text
pairs, the JAX package's recipe step for step:

* the logits ``q_emb @ p_emb.T / temperature`` in f32 (TF32 is off on
  the card, ``utils/device.resolve_device``); the loss is the mean of
  the row-wise and column-wise cross entropies over the valid rows, the
  accuracy the share of valid rows whose argmax is their own positive;
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

Over a ``parallel/mesh.make_train_mesh`` layout (the JAX trainer's
(data, model) mesh, one rank a device; every rank of it runs the same
calls):

* data: every rank tokenizes the whole batch, padded by cycling to a
  multiple of ``data``; a rank embeds its slice of the rows, and the
  embeddings are all-gathered across ``data``.  Every rank then computes
  the same whole-batch loss, so the gather's backward keeps only the
  rank's own rows of the gradient, and the sum of the ranks' gradients
  over ``data`` (one flat all-reduce) is the whole batch's.  The clone
  rows that padding adds are masked as in the JAX trainer: out of every
  other row's softmax, and out of the loss and the accuracy.
* model: ``param_spec`` splits each block's heads (q, k, v rows, ``out``
  columns) and FFN width (``ffn_in`` rows and bias, ``ffn_out``
  columns) over ``model``, the JAX ``param_spec`` in PyTorch's layouts;
  the rest is replicated.  Megatron's pair sits around each split block
  (``_ModelAxis``): identity forward and all-reduce backward where the
  replicated input enters, all-reduce forward and identity backward
  after ``out`` and ``ffn_out``.
* update: the clip's global norm sums the split tensors' squares across
  ``model`` and counts each replicated tensor once; AdamW runs on each
  rank's own tensors, so replicated ones stay bit-identical.
* checkpoints hold full tensors (gathered across ``model``, written by
  rank 0), so one restores onto any layout, one device included;
  ``sync_encoder`` publishes full weights to every rank's encoder.

The masters, ``mu`` and ``nu`` each live in one contiguous f32 buffer
(``flat_params``, ``flat_mu``, ``flat_nu``): the tensors that ``param_spec``
splits first, the replicated ones after ``split_numel`` elements.  The
module's parameters and the ``mu``/``nu`` dicts are views of them, and
the update is one ``ops/clip_adamw.clip_adamw`` call over the buffers and
the gradient concatenated in the same order: two kernel launches on the
card.

A ``flash`` encoder is refused, as JAX cannot differentiate its Pallas
kernel either.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from modular_rag_system_tpu_torch.ops.clip_adamw import adamw_scalars, clip_adamw
from modular_rag_system_tpu_torch.parallel import multihost
from modular_rag_system_tpu_torch.utils.profiling import TRACER


def param_spec(name: str) -> Optional[int]:
    """The dim of state-dict tensor ``name`` that the model axis splits,
    None when it is replicated: JAX ``models/train.py param_spec`` in
    ``nn.Linear``'s (out, in) layout.  q/k/v weights and biases split on
    dim 0 (whole heads: their rows are head-major), ``out.weight`` on dim
    1, ``ffn_in`` weight and bias on dim 0, ``ffn_out.weight`` on dim 1;
    the ``out`` and ``ffn_out`` biases, the embeddings and the LayerNorms
    are replicated."""
    parts = name.split(".")
    layer, kind = parts[-2], parts[-1]
    if len(parts) > 2 and parts[-3] == "attn":
        if layer in ("query", "key", "value"):
            return 0
        return 1 if layer == "out" and kind == "weight" else None
    if layer == "ffn_in":
        return 0
    return 1 if layer == "ffn_out" and kind == "weight" else None


def shard_params(params: Dict[str, torch.Tensor], model: int, index: int
                 ) -> Dict[str, torch.Tensor]:
    """Model rank ``index``'s part of full tensors (views)."""
    out = {}
    for k, v in params.items():
        dim = param_spec(k)
        out[k] = v if dim is None or model == 1 else v.chunk(model, dim)[index]
    return out


def gather_params(local: Dict[str, torch.Tensor], group, model: int
                  ) -> Dict[str, torch.Tensor]:
    """Full tensors from each model rank's part (the inverse of
    ``shard_params``); every rank of ``group`` calls it."""
    out = {}
    for k, v in local.items():
        dim = param_spec(k)
        v = v.detach()
        out[k] = v if dim is None or model == 1 else torch.cat(
            multihost.all_gather(v.contiguous(), group), dim=dim)
    return out


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return multihost.all_reduce_sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward over the model group, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return multihost.all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """Every data rank's rows, in rank order; the backward keeps this
    rank's rows of the gradient (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.rows = slice(index * x.shape[0], (index + 1) * x.shape[0])
        return torch.cat(multihost.all_gather(x.contiguous(), group))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None


class _ModelAxis:
    """The encoder's ``tp`` hook: Megatron's conjugate pair."""

    def __init__(self, group, size: int) -> None:
        self.group, self.size = group, size

    def enter(self, x):
        return _Enter.apply(x, self.group)

    def reduce(self, x):
        return _Reduce.apply(x, self.group)


class ContrastiveTrainer:
    """Symmetric-InfoNCE trainer on the encoder's device, alone
    (``mesh=None``) or as one rank of a ``make_train_mesh`` layout.

    ``sync_encoder`` publishes the trained weights to the serving
    encoder; a later trainer over the same encoder starts from them."""

    def __init__(
        self,
        encoder,
        mesh=None,
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
        if encoder.model_type != "bert":
            raise ValueError(f"ContrastiveTrainer trains BERT-class encoders only, not "
                             f"{encoder.model_type!r}")
        if encoder.module.attention_impl != "dense":
            raise ValueError(
                "ContrastiveTrainer trains only attention_impl='dense' encoders: "
                "the flash attention kernel has no backward")
        if mesh is not None and mesh.data_index is None:
            raise ValueError(f"this rank lies outside the {mesh.data}x{mesh.model} mesh")
        self.encoder = encoder
        self.mesh = mesh
        self.device = encoder.device
        self.learning_rate = learning_rate
        self.temperature = temperature
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.warmup_steps = warmup_steps
        self._n_model = 1 if mesh is None else mesh.model
        self._m_idx = 0 if mesh is None else mesh.model_index
        self._tp = _ModelAxis(mesh.model_group, mesh.model) if self._n_model > 1 else None
        self.model = encoder.make_module(param_dtype=torch.float32, tp=self._tp)
        self.model.load_state_dict(shard_params(encoder.params, self._n_model, self._m_idx))
        self.model.train()
        named = dict(self.model.named_parameters())
        # the flat order: model-split tensors, then the replicated ones
        order = sorted(named, key=lambda k: param_spec(k) is None)
        self.params: Dict[str, torch.nn.Parameter] = {k: named[k] for k in order}
        self.split_numel = sum(named[k].numel() for k in order if param_spec(k) is not None)
        self.flat_params = torch.cat([p.detach().reshape(-1) for p in self.params.values()])
        for k, v in self._views(self.flat_params).items():
            self.params[k].data = v
        self.flat_mu = torch.zeros_like(self.flat_params)
        self.flat_nu = torch.zeros_like(self.flat_params)
        self.mu = self._views(self.flat_mu)
        self.nu = self._views(self.flat_nu)
        self.step_count = 0

    def _views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each tensor of ``params`` as a view of a flat buffer."""
        out, at = {}, 0
        for k, p in self.params.items():
            out[k] = flat[at:at + p.numel()].view_as(p)
            at += p.numel()
        return out

    def _flat_grad(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The gradients in the flat buffers' order, in one buffer."""
        return torch.cat([grads[k].reshape(-1) for k in self.params])

    # ------------------------------------------------------------------
    def _tokenize(self, texts: Sequence[str]):
        # padded to max_len, no bucket crop (the JAX trainer's shapes)
        with TRACER.span("trainer.tokenize"):
            ids, mask = self.encoder.tokenizer.encode_batch(list(texts))
            if TRACER.on:
                TRACER.count("trainer.real_tokens", int(mask.sum()))
                TRACER.count("trainer.padded_tokens", mask.size)
            return (torch.from_numpy(ids).to(self.device, torch.long),
                    torch.from_numpy(mask).to(self.device))

    def _embed(self, texts: Sequence[str]) -> torch.Tensor:
        """The whole batch's embeddings: this rank's data slice through
        the module, then gathered across ``data``."""
        ids, mask = self._tokenize(texts)
        with TRACER.span("trainer.forward"):
            m = self.mesh
            if m is None or m.data == 1:
                return self.model(ids, mask)
            n = ids.shape[0] // m.data
            rows = slice(m.data_index * n, (m.data_index + 1) * n)
            return _GatherRows.apply(self.model(ids[rows], mask[rows]), m.data_group,
                                     m.data_index)

    def _loss(self, queries: Sequence[str], positives: Sequence[str]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        if len(queries) != len(positives):
            raise ValueError("queries and positives must align")
        n_data = 1 if self.mesh is None else self.mesh.data
        n_real = len(queries)
        if n_real % n_data:
            # pad to a multiple of the data axis by cycling the batch; the
            # clone rows are masked out of the loss
            target = -(-n_real // n_data) * n_data
            queries = [queries[i % n_real] for i in range(target)]
            positives = [positives[i % n_real] for i in range(target)]
        B = len(queries)
        q = self._embed(queries)  # (B, d) f32
        p = self._embed(positives)
        with TRACER.span("trainer.forward"):
            valid = (torch.arange(B, device=self.device) < n_real).float()
            logits = (q @ p.T) / self.temperature
            labels = torch.arange(B, device=self.device)
            # a clone row's logit against its original equals the
            # positive's: clone columns leave every other row's softmax,
            # clone rows weigh 0
            eye = torch.eye(B, dtype=torch.bool, device=self.device)
            clone_col = (valid[None, :] == 0) & ~eye
            n_valid = torch.clamp(valid.sum(), min=1.0)

            def masked_ce(L):
                ls = F.cross_entropy(torch.where(clone_col, -1e9, L), labels,
                                     reduction="none")
                return (ls * valid).sum() / n_valid

            loss = 0.5 * (masked_ce(logits) + masked_ce(logits.T))
            hits = (torch.where(clone_col, -1e9, logits).argmax(dim=1) == labels).float()
            return loss, (hits * valid).sum() / n_valid

    def _lr(self, count: int) -> float:
        """optax ``linear_schedule(0, lr, warmup)`` at update ``count``."""
        if self.warmup_steps <= 0:
            return self.learning_rate
        frac = 1.0 - min(count, self.warmup_steps) / self.warmup_steps
        return -self.learning_rate * frac + self.learning_rate

    def _sum_over_data(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The data ranks' gradients summed: one all-reduce of the flat
        gradient, handed to ``_update`` as it is."""
        return multihost.all_reduce_sum(self._flat_grad(grads), self.mesh.data_group)

    def _reduce_split(self, s: torch.Tensor) -> torch.Tensor:
        """The split tensors' sum of squares over the model group."""
        return multihost.all_reduce_sum(s.reshape(1), self._tp.group)[0]

    @torch.no_grad()
    def _update(self, grads: Union[Dict[str, torch.Tensor], torch.Tensor]) -> None:
        """Clip + AdamW on the flat buffers; ``grads``: the gradients by
        name, or already flat in the buffers' order."""
        with TRACER.span("trainer.update"):
            flat = grads if isinstance(grads, torch.Tensor) else self._flat_grad(grads)
            h = adamw_scalars(self._lr(self.step_count), self.step_count + 1,
                              self.weight_decay, self.clip_norm)
            clip_adamw(self.flat_params, flat, self.flat_mu, self.flat_nu, self.split_numel,
                       h, None if self._tp is None else self._reduce_split)

    def step(self, queries: Sequence[str], positives: Sequence[str]) -> Tuple[float, float]:
        """One optimization step on a batch of (query, positive) pairs;
        returns the batch's (loss, in-batch accuracy) before the update."""
        with TRACER.root("trainer.step"):
            loss, acc = self._loss(queries, positives)
            with TRACER.span("trainer.backward"):
                names = list(self.params)
                grads = dict(zip(names, torch.autograd.grad(
                    loss, [self.params[k] for k in names])))
                if self.mesh is not None and self.mesh.data > 1:
                    grads = self._sum_over_data(grads)
            self._update(grads)
            self.step_count += 1
            # where the host waits for the device
            with TRACER.span("trainer.readback"):
                return float(loss.detach()), float(acc)

    @torch.no_grad()
    def evaluate(self, queries: Sequence[str], positives: Sequence[str]
                 ) -> Tuple[float, float]:
        """(loss, in-batch accuracy) of a batch at the current weights."""
        loss, acc = self._loss(queries, positives)
        return float(loss), float(acc)

    def full(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors of this rank's ``params``, ``mu`` or ``nu``
        (gathered across ``model``; every model rank calls it)."""
        if self._tp is None:
            return {k: v.detach() for k, v in tensors.items()}
        return gather_params(tensors, self._tp.group, self._n_model)

    def sync_encoder(self) -> None:
        """Publish the trained weights to the serving encoder: a new
        serving module cast from a copy of the full f32 masters, swapped
        in whole (``MiniLMEncoder.publish``); the encoder's ``params`` are
        that copy.  Every rank of a layout calls it."""
        self.encoder.publish(self.full(self.params))

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Full masters, moments and step count to one ``torch.save``
        file; on a layout every rank calls it and rank 0 writes."""
        def host(d):
            return {k: v.cpu() for k, v in self.full(d).items()}

        state = {"params": host(self.params), "mu": host(self.mu), "nu": host(self.nu),
                 "step": self.step_count}
        if self.mesh is None:
            torch.save(state, path)
            return
        if multihost.rank() == 0:  # the grid's first rank
            torch.save(state, path)
        multihost.barrier(self.mesh.group)

    @torch.no_grad()
    def restore_checkpoint(self, path: str) -> None:
        """Load a checkpoint of any layout onto this trainer's."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        for name, dst in (("params", self.params), ("mu", self.mu), ("nu", self.nu)):
            if set(state[name]) != set(dst):
                raise ValueError(f"checkpoint {path} does not match this encoder's {name}")
            for k, v in shard_params(state[name], self._n_model, self._m_idx).items():
                if v.shape != dst[k].shape:
                    raise ValueError(f"checkpoint {path} does not match this encoder's "
                                     f"{name} {k}: {tuple(v.shape)}")
                dst[k].copy_(v)
        self.step_count = int(state["step"])
