"""The port's ``ContrastiveTrainer`` against the JAX package's, on the CPU.

Both trainers start from the same weights (the port's random init at a
seed, plus numpy-seeded noise so every bias and LayerNorm moves; mapped
into JAX with ``params_to_flax``) and see the same batches; the JAX
trainer runs on a (1, 1) mesh, so neither pads its batch.

Tolerances:

* float32: the step-0 loss within 1e-5; after 3 steps with clipping
  active (``clip_norm`` 0.05, under the gradient's norm) and
  ``warmup_steps=2``, every parameter within 2e-5, embedding rows
  included.  The attention key biases are the exception: their true
  gradient is 0 (a key bias adds one constant to a softmax row), so both
  trainers move them only by Adam-normalised rounding noise, at most the
  learning rates of the steps taken (1.5e-3).
* bfloat16: the two frameworks round at different points (XLA keeps
  excess precision inside fusions), so a loss within 2e-2 at each step,
  and the parameters' change over the 3 steps within 25% of JAX's change
  in norm.

Step 0 runs at learning rate 0 under the warm-up: it leaves every
parameter where it was, in both packages.  The other tests are the
port's counterparts of ``tests/test_train.py``, and the flat update
(``ops/clip_adamw.py``) against the per-tensor loop it replaced: the two
sum the squares in another order and the loop divides by the bias
corrections where the flat update multiplies by their f32 reciprocals,
so each value within 1e-5 of the loop's relative to itself plus 1e-6
of the buffer's largest (a first moment can cancel to near 0).
"""

import jax
import numpy as np
import pytest
import torch

from modular_rag_system_tpu.models.default_ckpt import _flatten, _unflatten
from modular_rag_system_tpu.models.encoder import MiniLMEncoder as JaxEncoder
from modular_rag_system_tpu.models.train import ContrastiveTrainer as JaxTrainer
from modular_rag_system_tpu.parallel.mesh import make_train_mesh
from modular_rag_system_tpu_torch.models.default_ckpt import params_from_flax, params_to_flax
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer, param_spec
from modular_rag_system_tpu_torch.ops.clip_adamw import adamw_scalars, clip_adamw

PAIRS = [
    ("what is jax", "jax is a numerical computing library"),
    ("tpu hardware", "tensor processing units accelerate matmuls"),
    ("python dataclass", "dataclasses generate init and repr"),
    ("sqlite storage", "sqlite is an embedded relational database"),
    ("http server", "servers respond to get and post requests"),
    ("text chunking", "documents are split into token windows"),
    ("cosine similarity", "normalized dot product measures similarity"),
    ("gradient descent", "optimizers update parameters from gradients"),
]
QS = [q for q, _ in PAIRS]
PS = [p for _, p in PAIRS]
ARCH = dict(dim=64, max_seq_len=32, batch_size=16, num_layers=2, num_heads=4,
            mlp_dim=128, vocab_size=1000)
LR, CLIP, WARMUP = 1e-3, 0.05, 2


def tiny_encoder(dtype="float32", **kw):
    return MiniLMEncoder(**ARCH, dtype=dtype, device="cpu", **kw)


def seeded_flat(seed=0):
    flat = params_to_flax(tiny_encoder(seed=seed).params, ARCH["num_heads"])
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(0.0, 0.02, v.shape)).astype(np.float32)
            for k, v in flat.items()}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request):
    """Three steps of both trainers from the same weights: per package the
    (loss, acc) of each step and the state dict before and after each."""
    dtype = request.param
    flat = seeded_flat()
    jt = JaxTrainer(JaxEncoder(**ARCH, dtype=dtype, params=_unflatten(flat)),
                    make_train_mesh(1, 1, devices=jax.devices("cpu")[:1]),
                    learning_rate=LR, clip_norm=CLIP, warmup_steps=WARMUP)
    pt = ContrastiveTrainer(tiny_encoder(dtype, state_dict=params_from_flax(flat)),
                            learning_rate=LR, clip_norm=CLIP, warmup_steps=WARMUP)
    loss, _ = pt._loss(QS, PS)
    grad_norm = float(torch.sqrt(sum(torch.sum(g * g) for g in torch.autograd.grad(
        loss, list(pt.params.values())))))
    out = {"dtype": dtype, "grad_norm": grad_norm, "jax": [], "port": [],
           "jax_params": [params_from_flax(flat)], "port_params": [
               {k: p.detach().clone() for k, p in pt.params.items()}]}
    for _ in range(3):
        out["jax"].append(jt.step(QS, PS))
        out["port"].append(pt.step(QS, PS))
        out["jax_params"].append(params_from_flax(_flatten(jax.tree.map(np.asarray, jt.params))))
        out["port_params"].append({k: p.detach().clone() for k, p in pt.params.items()})
    return out


def test_step0_loss_and_accuracy_match_jax(runs):
    (jl, ja), (pl, pa) = runs["jax"][0], runs["port"][0]
    assert abs(pl - jl) <= (1e-5 if runs["dtype"] == "float32" else 2e-2), (pl, jl)
    assert pa == ja


def test_step0_leaves_parameters_unchanged(runs):
    # warm-up: lr 0 at the first update; the moments move, the weights not
    for pkg in ("jax", "port"):
        before, after = runs[f"{pkg}_params"][:2]
        for k in before:
            torch.testing.assert_close(after[k], before[k], rtol=0, atol=0, msg=pkg + k)


def test_three_clipped_steps_match_jax(runs):
    assert runs["grad_norm"] > CLIP  # the clip is active at every step
    for (jl, ja), (pl, pa) in zip(runs["jax"], runs["port"]):
        if runs["dtype"] == "float32":
            assert abs(pl - jl) <= 1e-5 and pa == ja, (pl, jl, pa, ja)
        else:
            assert abs(pl - jl) <= 2e-2, (pl, jl)
    p0, jp, pp = runs["port_params"][0], runs["jax_params"][-1], runs["port_params"][-1]
    if runs["dtype"] == "float32":
        for k in jp:
            tol = 1.5 * LR if k.endswith("attn.key.bias") else 2e-5
            torch.testing.assert_close(pp[k], jp[k], rtol=0, atol=tol, msg=k)
    else:
        dj = torch.cat([(jp[k] - p0[k]).flatten() for k in jp])
        dp = torch.cat([(pp[k] - p0[k]).flatten() for k in jp])
        assert float((dp - dj).norm() / dj.norm()) <= 0.25


def test_training_reduces_loss():
    trainer = ContrastiveTrainer(tiny_encoder(), learning_rate=1e-3)
    losses = [trainer.step(QS, PS)[0] for _ in range(16)]
    assert losses[-1] < losses[0], losses
    assert trainer.step_count == 16
    assert np.isfinite(losses).all()


def test_training_improves_retrieval_alignment():
    enc = tiny_encoder()
    trainer = ContrastiveTrainer(enc, learning_rate=3e-3)
    accs = [trainer.step(QS, PS)[1] for _ in range(60)]
    # in-batch accuracy must rise well above the 1/8 chance level
    assert accs[-1] >= 0.25, accs[-5:]
    trainer.sync_encoder()
    sims = enc.encode_queries(QS) @ enc.encode(PS).T
    diag_rank = (sims >= sims.diagonal()[:, None]).sum(axis=1)
    assert diag_rank.mean() <= 4.5  # positives pulled toward the top


def test_sync_encoder_survives_further_training():
    enc = tiny_encoder()
    trainer = ContrastiveTrainer(enc, learning_rate=1e-3)
    served = enc.module
    trainer.step(QS, PS)
    trainer.sync_encoder()
    # a new serving module, swapped in whole; the encoder's f32 params are
    # a copy of the masters
    assert enc.module is not served
    for k, p in trainer.params.items():
        assert enc.params[k] is not p
        torch.testing.assert_close(enc.params[k], p.detach(), rtol=0, atol=0)
    emb_before = enc.encode(["probe sentence"])
    trainer.step(QS, PS)
    np.testing.assert_allclose(enc.encode(["probe sentence"]), emb_before, atol=1e-6)
    # a second trainer over the same encoder starts from the published
    # weights and leaves the serving module alone until it syncs
    trainer2 = ContrastiveTrainer(enc, learning_rate=1e-3)
    for k, p in trainer2.params.items():
        torch.testing.assert_close(p.detach(), enc.params[k], rtol=0, atol=0)
    trainer2.step(QS, PS)
    np.testing.assert_allclose(enc.encode(["probe sentence"]), emb_before, atol=1e-6)


def test_mismatched_pairs_raise():
    trainer = ContrastiveTrainer(tiny_encoder())
    with pytest.raises(ValueError):
        trainer.step(["a"], ["b", "c"])
    assert trainer.step_count == 0


def test_checkpoint_roundtrip(tmp_path):
    trainer = ContrastiveTrainer(tiny_encoder(), learning_rate=1e-3)
    for _ in range(3):
        trainer.step(QS, PS)
    ckpt = str(tmp_path / "ckpt.pt")
    trainer.save_checkpoint(ckpt)
    # a fresh trainer over an encoder of other weights restores and
    # continues as the original does
    trainer2 = ContrastiveTrainer(tiny_encoder(seed=1), learning_rate=1e-3)
    trainer2.restore_checkpoint(ckpt)
    assert trainer2.step_count == trainer.step_count == 3
    la, _ = trainer.step(QS, PS)
    lb, _ = trainer2.step(QS, PS)
    assert abs(la - lb) < 1e-5, (la, lb)
    for k, p in trainer.params.items():
        torch.testing.assert_close(trainer2.params[k], p, rtol=0, atol=1e-6)


def test_checkpoint_of_another_architecture_refused(tmp_path):
    ckpt = str(tmp_path / "ckpt.pt")
    ContrastiveTrainer(tiny_encoder()).save_checkpoint(ckpt)
    other = MiniLMEncoder(**{**ARCH, "num_layers": 1}, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        ContrastiveTrainer(other).restore_checkpoint(ckpt)


def test_flash_encoder_refused():
    enc = tiny_encoder(attention_impl="flash")
    with pytest.raises(ValueError, match="dense"):
        ContrastiveTrainer(enc)


# ---------------------------------------------------------------------------
# The flat clip + AdamW update against the per-tensor loop it replaced


def loop_update(params, grads, mu, nu, count, lr, wd, clip):
    """The trainer's update before the flat buffers, one tensor at a time
    (optax's clip_by_global_norm, then adamw), in place."""
    sq = {k: torch.sum(g * g) for k, g in grads.items()}
    norm = torch.sqrt(sum(sq.values()))
    keep = norm < clip
    bc1, bc2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
    for k, p in params.items():
        g = torch.where(keep, grads[k], grads[k] / norm * clip)
        m = mu[k].mul_(0.9).add_((1.0 - 0.9) * g)
        v = nu[k].mul_(0.999).add_((1.0 - 0.999) * (g * g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        p.add_((u + wd * p) * -lr)
    return norm


def assert_flat_close(got, ref, what):
    tol = 1e-5 * ref.abs() + 1e-6 * ref.abs().max()
    bad = (got - ref).abs() > tol
    assert not bad.any(), f"{what}: {int(bad.sum())} values off, max |d| " \
        f"{float((got - ref).abs().max()):.3e}"


SHAPES = [(48, 16), (16,), (33, 7), (3,), (128,), (5, 5, 4), (1,)]


@pytest.mark.parametrize("split_at", ["start", "mid", "end"])
@pytest.mark.parametrize("clipped", [False, True])
def test_flat_update_matches_per_tensor_loop(clipped, split_at):
    rng = np.random.default_rng(3)
    names = [f"t{i}" for i in range(len(SHAPES))]
    params = {k: torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32))
              for k, s in zip(names, SHAPES)}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    flat = {"p": torch.cat([p.reshape(-1) for p in params.values()])}
    flat["mu"], flat["nu"] = torch.zeros_like(flat["p"]), torch.zeros_like(flat["p"])
    n = flat["p"].numel()
    split = {"start": 0, "mid": 7 * n // 13, "end": n}[split_at]
    clip, wd = 1.0, 0.01
    for count, lr in ((1, 0.0), (2, 1e-3), (3, 2e-3)):  # a warm-up step at lr 0, then two
        scale = (3.0 if clipped else 0.3) * clip / np.sqrt(n)
        grads = {k: torch.from_numpy(rng.normal(0, scale, s).astype(np.float32))
                 for k, s in zip(names, SHAPES)}
        want = loop_update(params, grads, mu, nu, count, lr, wd, clip)
        p0 = flat["p"].clone()
        got = clip_adamw(flat["p"], torch.cat([g.reshape(-1) for g in grads.values()]),
                         flat["mu"], flat["nu"], split, adamw_scalars(lr, count, wd, clip))
        assert (float(want) >= clip) == clipped
        assert abs(float(got) - float(want)) <= 1e-6 * float(want)
        for name, d in (("p", params), ("mu", mu), ("nu", nu)):
            assert_flat_close(flat[name], torch.cat([t.reshape(-1) for t in d.values()]),
                              f"step {count} {name}")
        if lr == 0.0:
            assert torch.equal(flat["p"], p0)  # the warm-up moves the moments only


@pytest.mark.parametrize("clip", [0.05, 1e6])
def test_trainer_update_matches_per_tensor_loop(clip):
    trainer = ContrastiveTrainer(tiny_encoder(), learning_rate=LR, clip_norm=clip,
                                 warmup_steps=WARMUP)
    params = {k: p.detach().clone() for k, p in trainer.params.items()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    for _ in range(3):
        loss, _ = trainer._loss(QS, PS)
        grads = dict(zip(trainer.params, torch.autograd.grad(
            loss, list(trainer.params.values()))))
        count, lr = trainer.step_count + 1, trainer._lr(trainer.step_count)
        norm = loop_update(params, grads, mu, nu, count, lr, trainer.weight_decay, clip)
        assert (float(norm) >= clip) == (clip < 1.0)
        trainer._update(grads)
        trainer.step_count += 1
        for name, mine, ref in (("p", trainer.params, params), ("mu", trainer.mu, mu),
                                ("nu", trainer.nu, nu)):
            for k in ref:
                assert_flat_close(mine[k].detach(), ref[k], f"{name} {k}")


def _assert_views(trainer):
    """``params``, ``mu`` and ``nu`` are views of the flat buffers, in the
    flat order, and the module trains the same parameters."""
    module = dict(trainer.model.named_parameters())
    at = 0
    for k, p in trainer.params.items():
        assert module[k] is p
        for flat, t in ((trainer.flat_params, p), (trainer.flat_mu, trainer.mu[k]),
                        (trainer.flat_nu, trainer.nu[k])):
            assert t.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr(), k
            assert t.data_ptr() == flat.data_ptr() + 4 * at, k
        assert (at < trainer.split_numel) == (param_spec(k) is not None), k
        at += p.numel()
    assert at == trainer.flat_params.numel()


def test_params_and_moments_stay_views_of_the_flat_buffers(tmp_path):
    trainer = ContrastiveTrainer(tiny_encoder(), learning_rate=1e-3)
    _assert_views(trainer)
    assert 0 < trainer.split_numel < trainer.flat_params.numel()
    for _ in range(2):
        trainer.step(QS, PS)
    _assert_views(trainer)
    ckpt = str(tmp_path / "ckpt.pt")
    trainer.save_checkpoint(ckpt)
    trainer2 = ContrastiveTrainer(tiny_encoder(seed=1), learning_rate=1e-3)
    trainer2.restore_checkpoint(ckpt)
    trainer2.sync_encoder()
    _assert_views(trainer2)
    for name in ("flat_params", "flat_mu", "flat_nu"):
        assert torch.equal(getattr(trainer2, name), getattr(trainer, name)), name
    trainer2.step(QS, PS)
    _assert_views(trainer2)


@pytest.mark.parametrize("bad", ["length", "dtype", "shape", "split"])
def test_clip_adamw_refuses_mismatched_buffers(bad):
    p, mu, nu = torch.zeros(10), torch.zeros(10), torch.zeros(10)
    g = {"length": torch.zeros(9), "dtype": torch.zeros(10, dtype=torch.float64),
         "shape": torch.zeros(2, 5)}.get(bad, torch.zeros(10))
    with pytest.raises(ValueError):
        clip_adamw(p, g, mu, nu, 11 if bad == "split" else 4, adamw_scalars(1e-3, 1, 0.0, 1.0))
