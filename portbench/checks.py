"""The reference side of each kind of cell: the plain reference built
from the configuration file (weights from the bundled data files or from
the seed, never from the program), and the numbers compared.  Each
``*_numbers`` function takes what the window produced, as plain Python
and numpy data read from the program's outputs after the window, and
runs once the program's state is freed.

``precision`` is "f32" to judge the program's output; any other value
judges instead the reference put in the program's place: "fp8" (the
control), "bf16" (a witness at the configurations' own precision), and
for training "half" and "reversed" (planted faults)."""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from portbench import data
from portbench.reference import bert
from portbench.reference import train as ref_train
from portbench.reference.wordpiece import WordPiece, load_vocab
from portbench.common import ASSETS, log


def arch_of(cfg: Dict[str, Any]) -> dict:
    """The encoder's widths as the reference names them."""
    return {k: cfg[k] for k in ("num_layers", "hidden", "heads", "mlp_dim", "vocab_size",
                                "max_len")}


def dense_weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's dense weights: the bundled checkpoint's, or
    BERT's initialisation drawn from the seed."""
    if cfg["weights"] == "bundled":
        return bert.bundled_weights(device)
    return bert.random_weights(arch_of(cfg), data.torch_seed(seed, "weights"), device)


def tokenizer(cfg: Dict[str, Any]) -> WordPiece:
    """The served tokenizer: the bundled vocab, or the padded one the
    benchmark writes into its checkpoint; cut at the served length."""
    if cfg["weights"] == "bundled":
        vocab = load_vocab(ASSETS / "default_encoder" / "vocab.txt")
    else:
        vocab = data.minilm_vocab(cfg["vocab_size"])
    return WordPiece(vocab, cfg["served_len"])


def embed(cfg: Dict[str, Any], seed: int, device, texts: List[str],
          precision: str = "f32") -> torch.Tensor:
    """The reference's unit rows of ``texts``: the dense encoder alone
    (the benchmark holds no reference of the lexical half)."""
    if cfg["lexical_dim"] > 0:
        raise ValueError("the benchmark's reference embeds dense rows only")
    bert.no_tf32()
    return bert.embed(dense_weights(cfg, seed, device), arch_of(cfg), tokenizer(cfg),
                      list(texts), device, precision)


def ingest_numbers(run, rows: List[dict], precision: str = "f32") -> Dict[str, float]:
    """``rows``: the judged documents of the window, each with its
    ``content``, ``source``, ``id`` and what the program holds for it
    after the window (``stored`` (content, source) or None, ``emb`` its
    index row).  Numbers: ``row_gap``, the widest L2 distance between a
    stored row and the reference's embedding; ``store_mismatch``, the
    documents missing from the store or the index, or held under another
    content, source or row, plus 1 if the store and the index disagree
    on their row count."""
    cfg, seed, dev = run.config, run.seed, run.device
    texts = [r["content"] for r in rows]
    want = embed(cfg, seed, dev, texts)
    got = (embed(cfg, seed, dev, texts, precision) if precision != "f32" else
           torch.stack([torch.as_tensor(r["emb"], dtype=torch.float32) for r in rows]
                       ).to(dev))
    gap = float(torch.linalg.vector_norm(got - want, dim=1).max()) if rows else 0.0
    mismatch = sum(1 for r in rows if r["stored"] != (r["content"], r["source"])
                   or r["id"] != data.content_id(r["content"], r["source"]))
    mismatch += int(run.state.get("count_mismatch", 0))
    return {"row_gap": gap, "store_mismatch": float(mismatch)}


def train_numbers(run, prog: Dict[str, Any], precision: str = "f32") -> Dict[str, float]:
    """``prog``: the program's losses of the three set-up steps, its first
    clipped gradient and its weights' change over the three steps, keyed
    by the program's leaf names (f32 tensors), and its module's
    embeddings of the first batch's queries and positives after them.
    ``precision="half"`` judges instead the reference stepped on half of
    each batch, ``"reversed"`` the reference stepped on the negated
    gradient."""
    cfg, p = run.config, run.params
    bert.no_tf32()
    arch = arch_of(cfg)
    tok = WordPiece(tokenizer(cfg).vocab, cfg["max_len"])
    w0 = dense_weights(cfg, run.seed, run.device)
    batches = run.state["setup_batches"]
    for i, b in enumerate(batches, start=1):
        pos = [d for _, d in b]
        log(f"set-up batch {i}: {len(pos) - len(set(pos))} positives repeat another "
            f"pair's; {len(b) - len({q for q, _ in b})} queries repeat")
    kw = dict(lr=p["learning_rate"], temperature=p["temperature"],
              weight_decay=p["weight_decay"], clip_norm=p["clip_norm"])
    losses, grad, w3 = ref_train.run(w0, arch, tok, batches, run.device, **kw)
    texts = [q for q, _ in batches[0]] + [d for _, d in batches[0]]
    ref_emb = bert.embed(w3, arch, tok, texts, run.device)
    change = {k: w3[k] - w0[k] for k in grad}
    if precision == "half":
        # the fault of a step that leaves half of its batch out and takes
        # the mean over the rest, planted in the reference
        half = [b[: len(b) // 2] for b in batches]
        c_losses, c_grad, c_w3 = ref_train.run(w0, arch, tok, half, run.device, **kw)
        got = (c_losses, c_grad, {k: c_w3[k] - w0[k] for k in c_grad},
               bert.embed(c_w3, arch, tok, texts, run.device))
    elif precision == "reversed":
        # the fault of a step that takes the negated gradient: its norms
        # are right, its directions are not
        c_losses, c_grad, c_w3 = ref_train.run(w0, arch, tok, batches, run.device,
                                               reverse=True, **kw)
        got = (c_losses, c_grad, {k: c_w3[k] - w0[k] for k in c_grad},
               bert.embed(c_w3, arch, tok, texts, run.device))
    elif precision != "f32":
        c_losses, c_grad, c_w3 = ref_train.run(w0, arch, tok, batches, run.device,
                                               precision=precision, **kw)
        got = (c_losses, c_grad, {k: c_w3[k] - w0[k] for k in c_grad},
               bert.embed(c_w3, arch, tok, texts, run.device, precision))
    else:
        names = ref_train.leaf_names(arch)
        got = (prog["losses"], {names[k]: v.to(run.device) for k, v in prog["grad"].items()},
               {names[k]: v.to(run.device) for k, v in prog["change"].items()},
               prog["emb"].to(run.device))
    return ref_train.judge(*got, losses, grad, change, ref_emb)
