"""Adding documents: a closed loop of ``RAGEngine.add_documents`` calls of
text documents (no embeddings, content-hash ids), the device-resident
``encode_device`` path.

Set-up writes the configuration's local HF checkpoint (weights drawn
from the seed) under the run's scratch directory, builds the engine on
it, fills seeded filler rows to ``corpus_rows``, and warms the call's
shapes with ``warm_calls`` calls of the warm-up stream (the first of
which grows the index's capacity past the filled rows).  The window
reports ``ingest_rows_s``: the rows added over its whole wall time.

Judged after the window: ``judge_max`` of the window's documents drawn
from the seed, read back from the store by id and from the index's
master rows.  ``calibrate`` judges the control's embeddings of the
documents a window of ``CALLS_PER_S`` calls a second would judge."""

from __future__ import annotations

import itertools
import time

import numpy as np

from portbench import checks, data, engines
from portbench.common import log

# calls a second of the window (my chip runs: 5,700-6,200 rows/s)
CALLS_PER_S = 23


def _docs(run, stream: str):
    p = run.params
    return data.document_batches(data.torch_seed(run.seed, stream), p["batch"],
                                 p["pieces_min"], p["pieces_max"])


def setup(run) -> None:
    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.engine import RAGEngine
    from modular_rag_system_tpu_torch.types import Document

    cfg, p = run.config, run.params
    w = checks.dense_weights(cfg, run.seed, run.device)
    ckpt = engines.write_hf_checkpoint(run.work / "checkpoint", cfg["hf_config"],
                                       data.minilm_vocab(cfg["vocab_size"]), w)
    del w
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
    # the window's documents, drawn before it opens: as many as the
    # mix's ``max_rows_per_s`` fills the window with; a faster program
    # draws the rest of the same stream inside the window
    n = int(np.ceil(p["max_rows_per_s"] * run.seconds / p["batch"])) + 1
    run.stream = _docs(run, "window")
    run.pool = list(itertools.islice(run.stream, n))
    run.drawn = n


def _judged(run, docs) -> list:
    """The indices, in order, of the judged documents among ``docs``."""
    pick = data.rng(run.seed, "judge").permutation(len(docs))[:run.params["judge_max"]]
    return sorted(int(x) for x in pick)


def window(run) -> dict:
    from modular_rag_system_tpu_torch.types import Document

    eng = run.engine
    count0 = eng.index.count
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        if calls == len(run.pool):
            run.pool.append(next(run.stream))
        eng.add_documents([Document(content=c, source=s) for c, s in run.pool[calls]])
        calls += 1
        run.tick()
    run.sync()
    wall = time.perf_counter() - t0
    rows = eng.index.count - count0
    run.units = calls
    run.calls = calls
    log(f"ingest: {calls} calls ({run.drawn} drawn before the window), {rows} "
        f"rows in {wall:.3f} s; count {eng.index.count}, capacity {eng.index.capacity}")
    return {"attempted": calls * run.params["batch"], "failed": 0, "window_s": wall,
            "metrics": {"ingest_rows_s": rows / wall}}


def release(run) -> None:
    eng = run.engine
    docs = [d for batch in run.pool[:run.calls] for d in batch]
    rows = []
    for i in _judged(run, docs):
        content, source = docs[i]
        doc_id = data.content_id(content, source)
        stored = eng.store.get_by_id(doc_id)
        r = eng.store.row_of(doc_id)
        emb = (eng.index.E[r].float().cpu().numpy() if r is not None and r < eng.index.count
               else np.zeros(eng.index.dim, np.float32))
        rows.append({"content": content, "source": source, "id": stored.id if stored else "",
                     "stored": (stored.content, stored.source) if stored else None,
                     "emb": emb})
    run.state["count_mismatch"] = int(eng.store.max_row() + 1 != eng.index.count)
    run.rows = rows
    eng.store.close()
    run.engine = None


def check(run) -> dict:
    return checks.ingest_numbers(run, run.rows)


def calibrate(run, precision: str) -> dict:
    """The numbers of ``precision``'s reference in the program's place,
    on the documents a window of ``run.seconds`` judges."""
    calls = int(CALLS_PER_S * run.seconds)
    docs = [d for b in itertools.islice(_docs(run, "window"), calls) for d in b]
    rows = [{"content": docs[i][0], "source": docs[i][1], "stored": docs[i],
             "id": data.content_id(*docs[i]), "emb": None} for i in _judged(run, docs)]
    return checks.ingest_numbers(run, rows, precision)
