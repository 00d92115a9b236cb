"""Adding long documents whole: a closed loop of ``RAGEngine.add_documents``
calls of ``batch`` long text documents (no embeddings, content-hash ids)
through a ModernBERT encoder, the device-resident ``encode_device`` path.

Set-up writes the configuration's local HF ModernBERT checkpoint
(``reference/modernbert.random_weights`` drawn from the seed) under the
run's scratch directory, builds the engine on it, fills seeded filler
rows to ``corpus_rows``, warms the call's shapes with ``warm_calls`` calls
of the warm-up stream and checks the route they took.  The window, the
read-back after it and ``ingest_rows_s`` are the ``ingest`` kind's.

Judged after the window: ``judge_max`` of the window's documents drawn
from the seed, read back from the store by id and from the index's
master rows, against ``reference/modernbert`` in f32, one text a forward;
and the first ``token_docs`` of them once more through the engine's
encoder alone, one text a call, whose final hidden states (the output
of its module's ``final_norm``, before the pooling) are held against the
reference's token by token.  The pooled rows average the attention's
work over thousands of tokens, so they see little of a fault in it at
weights this small (attention near uniform): ``token_gap`` does.
``calibrate`` judges the control's embeddings of the documents a window
of ``CALLS_PER_S`` calls a second would judge, or, with ``precision=
"program"``, the program's own embeddings of them (its encoder alone, in
calls of ``batch``), so that a dozen seeds read in one process."""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from portbench import common, data, engines
from portbench.common import log
from portbench.reference import modernbert as ref
from portbench.reference.wordpiece import WordPiece

_INGEST = common.traffic("ingest")
window = _INGEST.window

# calls a second of a window, for the documents ``calibrate`` judges (a
# call of 8 took 0.43-0.49 s on an H100 SXM, untraced and traced)
CALLS_PER_S = 1.8


def _docs(run, stream: str):
    p = run.params
    return data.document_batches(data.torch_seed(run.seed, stream), p["batch"],
                                 p["pieces_min"], p["pieces_max"])


def _weights(run) -> Dict[str, torch.Tensor]:
    return ref.random_weights(run.config["hf_config"], data.torch_seed(run.seed, "weights"),
                              run.device)


def _tokenizer(cfg) -> WordPiece:
    return WordPiece(data.minilm_vocab(cfg["hf_config"]["vocab_size"]), cfg["served_len"])


def _checkpoint(run):
    cfg = run.config
    return engines.write_hf_checkpoint(run.work / "checkpoint", cfg["hf_config"],
                                       data.minilm_vocab(cfg["hf_config"]["vocab_size"]),
                                       _weights(run))


def setup(run) -> None:
    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.engine import RAGEngine
    from modular_rag_system_tpu_torch.types import Document

    cfg, p = run.config, run.params
    ckpt = _checkpoint(run)
    rc = engines.rag_config(cfg, run.work / "store", {"embedding.hf_checkpoint": str(ckpt)})
    eng = RAGEngine(rc, device=run.device)
    engines.fill(eng, run.seed, cfg["corpus_rows"])
    kernels.reset_launches()
    warm = _docs(run, "warm")
    for _ in range(p["warm_calls"]):
        eng.add_documents([Document(content=c, source=s) for c, s in next(warm)])
    run.sync()
    engines.check_route(run.cell.get("route"), eng, dict(kernels.launches))
    run.engine = eng
    # the window's documents, drawn before it opens, as ``ingest`` does
    n = int(np.ceil(p["max_rows_per_s"] * run.seconds / p["batch"])) + 1
    run.stream = _docs(run, "window")
    run.pool = list(itertools.islice(run.stream, n))
    run.drawn = n


def _program_hidden(enc, text: str) -> torch.Tensor:
    """The program's final hidden states of one text at its live
    positions: the output of its module's ``final_norm``, (n, hidden)."""
    seen = {}
    module = enc.module
    hooks = (module.register_forward_pre_hook(lambda m, a: seen.update(mask=a[1])),
             module.final_norm.register_forward_hook(lambda m, a, out: seen.update(h=out)))
    try:
        enc.encode_device([text])
    finally:
        for h in hooks:
            h.remove()
    return seen["h"][0][seen["mask"][0].bool()].float()


def _numbers(run, rows: List[dict], got=None, precision: str = "f32",
             enc=None) -> Dict[str, float]:
    """``rows`` as ``checks.ingest_numbers`` takes them.  ``row_gap``: the
    widest L2 distance between a stored row (or ``got``'s, or the
    reference's at ``precision``) and the f32 reference's embedding;
    ``token_gap``: over the first ``token_docs`` rows, the widest RMS over
    a document's tokens of the L2 distance between ``enc``'s final hidden
    states (or the reference's at ``precision``) and the f32 reference's,
    over sqrt(hidden) (the states are unit RMS a token); ``store_mismatch``:
    as ``checks.ingest_numbers`` counts it."""
    cfg, dev = run.config, run.device
    hf = cfg["hf_config"]
    ref.no_tf32()
    w, tok, texts = _weights(run), _tokenizer(cfg), [r["content"] for r in rows]
    want = ref.embed(w, hf, tok, texts, dev)
    if precision != "f32":
        got = ref.embed(w, hf, tok, texts, dev, precision)
    elif got is None:
        got = torch.stack([torch.as_tensor(r["emb"], dtype=torch.float32) for r in rows]
                          ).to(dev) if rows else want
    gap = float(torch.linalg.vector_norm(got.to(dev) - want, dim=1).max()) if rows else 0.0
    token_gap = 0.0
    with torch.no_grad():
        for t in texts[:run.params["token_docs"]]:
            ids = ref.ids_of(tok, t, dev)
            want_h = ref.hidden(w, hf, ids)
            got_h = (ref.hidden(w, hf, ids, precision) if precision != "f32"
                     else _program_hidden(enc, t).to(dev))
            if got_h.shape != want_h.shape:
                token_gap = float("inf")
                continue
            d = torch.linalg.vector_norm(got_h - want_h, dim=1)
            token_gap = max(token_gap, float(d.square().mean().sqrt()) / hf["hidden_size"] ** 0.5)
    mismatch = sum(1 for r in rows if r["stored"] != (r["content"], r["source"])
                   or r["id"] != data.content_id(r["content"], r["source"]))
    mismatch += int(run.state.get("count_mismatch", 0))
    return {"row_gap": gap, "token_gap": token_gap, "store_mismatch": float(mismatch)}


def release(run) -> None:
    """``ingest``'s read-back; the engine's encoder is kept for ``check``."""
    from portbench.hooks import dense_of

    run.encoder = dense_of(run.engine)
    _INGEST.release(run)


def check(run) -> dict:
    enc, run.encoder = run.encoder, None
    return _numbers(run, run.rows, enc=enc)


def calibrate(run, precision: str) -> dict:
    """The numbers of ``precision``'s reference in the program's place,
    or of the program's encoder (``"program"``), on the documents a
    window of ``run.seconds`` judges."""
    calls = int(np.ceil(CALLS_PER_S * run.seconds))
    docs = [d for b in itertools.islice(_docs(run, "window"), calls) for d in b]
    pick = data.rng(run.seed, "judge").permutation(len(docs))[:run.params["judge_max"]]
    rows = [{"content": docs[i][0], "source": docs[i][1], "stored": docs[i],
             "id": data.content_id(*docs[i]), "emb": None} for i in sorted(int(x) for x in pick)]
    if precision != "program":
        return _numbers(run, rows, precision=precision)
    from modular_rag_system_tpu_torch.models import build_encoder

    rc = engines.rag_config(run.config, run.work / "store",
                            {"embedding.hf_checkpoint": str(_checkpoint(run))})
    enc = build_encoder(rc, device=run.device)
    b = run.params["batch"]
    texts = [r["content"] for r in rows]
    got = torch.cat([enc.encode_device(texts[i:i + b]) for i in range(0, len(texts), b)])
    log(f"calibrate: the program's embeddings of {len(texts)} documents")
    return _numbers(run, rows, got=got, enc=enc)
