"""Fine-tuning from feedback: back-to-back ``ContrastiveTrainer.step``
calls on batches of (query, positive) pairs, the trainer that
``fine_tune_from_feedback`` and the encoder builder run.

Set-up builds the configuration's encoder through the program's encoder
factory, builds one trainer over its dense half, and drives it from the
seed through ``setup_steps`` steps of the window's own call, on batches
that share no pair: their losses, the first step's clipped gradient (from
the optimizer's first moment), the weights' change over those steps and
the trained module's embeddings of the first batch's texts after them
are what the check compares.  The window then steps the same trainer
and reports ``train_tokens_s``: the real tokens (after the tokenizer's
cut, without padding) of every query and positive stepped, over the
window's whole wall time.

``calibrate`` reads the same numbers for a reference put in the
program's place (``precision``), or, with ``precision="program"``, for
the program's own set-up steps without a window, so that a dozen seeds
read in one process."""

from __future__ import annotations

import itertools
import time

import torch

from portbench import checks, data
from portbench.common import log
from portbench.roofline.train_step import step_flops

_B1 = 0.9


def _batches(run, n: int) -> list:
    """The seed's first ``n`` batches of pairs: the set-up steps', then
    the window's pool."""
    p = run.params
    gen = data.pair_batches(data.torch_seed(run.seed, "pairs"), p["batch"], p["qa_share"],
                            p["span_min"], p["span_max"])
    return list(itertools.islice(gen, n))


def setup(run) -> None:
    from modular_rag_system_tpu_torch.models import build_encoder
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    from portbench import engines

    cfg, p = run.config, run.params
    rc = engines.rag_config(cfg, run.work / "store")
    enc = build_encoder(rc, device=run.device)
    dense = getattr(enc, "dense", enc)
    trainer = ContrastiveTrainer(dense, learning_rate=p["learning_rate"],
                                 temperature=p["temperature"],
                                 weight_decay=p["weight_decay"], clip_norm=p["clip_norm"])
    tok = checks.tokenizer(cfg)
    batches = _batches(run, p["setup_steps"] + p["pool"])
    run.state["setup_batches"] = batches[:p["setup_steps"]]
    run.pool = batches[p["setup_steps"]:]
    lengths = [[tok.length(t) for pair in b for t in pair] for b in run.pool]
    run.tokens = [sum(x) for x in lengths]
    run.flops = [step_flops(checks.arch_of(cfg), x) for x in lengths]
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    losses = []
    for step, b in enumerate(run.state["setup_batches"], start=1):
        loss, _ = trainer.step([q for q, _ in b], [d for _, d in b])
        losses.append(loss)
        if step == 1:
            grad = {k: (m / (1.0 - _B1)).detach().clone() for k, m in trainer.mu.items()}
    b1 = run.state["setup_batches"][0]
    with torch.no_grad():
        emb = trainer._embed([q for q, _ in b1] + [d for _, d in b1]).float().cpu()
    run.sync()
    run.prog = {"losses": losses, "grad": grad, "emb": emb,
                "change": {k: trainer.params[k].detach() - before[k] for k in before}}
    del before
    log(f"finetune set-up steps: losses {losses}")
    run.trainer = trainer


def window(run) -> dict:
    tr = run.trainer
    steps = tokens = flops = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        i = steps % len(run.pool)
        b = run.pool[i]
        tr.step([q for q, _ in b], [d for _, d in b])
        steps += 1
        tokens += run.tokens[i]
        flops += run.flops[i]
        run.tick()
    wall = time.perf_counter() - t0
    run.units = steps
    run.state["tokens"], run.state["flops"] = tokens, flops
    log(f"finetune: {steps} steps, {tokens} real tokens in {wall:.3f} s")
    return {"attempted": steps, "failed": 0, "window_s": wall,
            "metrics": {"train_tokens_s": tokens / wall}}


def release(run) -> None:
    run.prog = {"losses": run.prog["losses"], "emb": run.prog["emb"],
                "grad": {k: v.cpu() for k, v in run.prog["grad"].items()},
                "change": {k: v.cpu() for k, v in run.prog["change"].items()}}
    run.trainer = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run) -> dict:
    return checks.train_numbers(run, run.prog)


def calibrate(run, precision: str) -> dict:
    if precision == "program":
        setup(run)
        release(run)
        return check(run)
    run.state["setup_batches"] = _batches(run, run.params["setup_steps"])
    return checks.train_numbers(run, None, precision)
