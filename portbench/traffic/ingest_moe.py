"""Adding long sections through a mixture-of-experts embedder: a closed
loop of ``RAGEngine.add_documents`` calls of ``batch`` text documents
of ``tokens_min``..``tokens_max`` tokens (``sections``; no embeddings,
content-hash ids) through a DeepSeek-V3 encoder pooled at
its last token, the device-resident ``encode_device`` path.

Set-up first asks the program for its DeepSeek-V3 module (a program
without one fails at once), then writes the configuration's local HF
checkpoint in BF16 under the run's scratch directory, streamed tensor by
tensor from ``reference/deepseek_v3.draw`` on the device (31.2 GB at the
published size: free space is checked first), builds the engine on it,
drops the file, fills seeded filler rows to ``corpus_rows``, warms the
call's shapes with ``warm_calls`` calls of the warm-up stream and checks
the route they took.  The window, the read-back after it and
``ingest_rows_s`` are the ``ingest`` kind's.

Judged after the window: ``judge_max`` of the window's documents drawn
from the seed, read back from the store by id and from the index's
master rows.  Each window call that holds one runs once more through the
engine's encoder, as the window sent it (``program_pass``), which
records the program's experts of each judged token in each expert layer
and, for the first ``token_docs``, its final hidden states (the output
of the module's ``final_norm``).  Then the encoder is
freed and ``reference/deepseek_v3`` runs the documents in f32, layer by
layer, drawing each layer's weights from the seed, and following the
program's experts within the tie band.  Numbers: ``row_gap`` (stored rows
against the reference's), ``token_gap`` (the final hidden states),
``route_gap`` (the program's choices below the band: the count over the
judged tokens and layers) and ``store_mismatch``.  ``calibrate`` judges
the control's numbers (the reference at a lower precision in the
program's place, its own experts held against the f32 reference's), or
with ``precision="program"`` the program's own (its encoder alone), on
the documents a window of ``CALLS_PER_S`` calls a second judges, in
those calls."""

from __future__ import annotations

import gc
import itertools
import json
import shutil
import struct
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from portbench import common, data, engines
from portbench.common import log
from portbench.reference import deepseek_v3 as ref
from portbench.reference.wordpiece import WordPiece

_INGEST = common.traffic("ingest")
window = _INGEST.window

# calls a second of a window, for the documents ``calibrate`` judges (a
# call of 16 took ~1.7-2.0 s on an H100 80GB HBM3)
CALLS_PER_S = 0.5


def sections(seed: int, batch: int, tokens_min: int, tokens_max: int, tok: WordPiece
             ) -> Iterator[List[Tuple[str, str]]]:
    """Endless batches of distinct (content, source) documents of
    ``tokens_min``..``tokens_max`` WordPiece tokens, [CLS] and [SEP]
    included.  A document joins bundled passages or sentences, taken in an
    order drawn from the seed, each that still fits its target length,
    until less room is left than the shortest piece takes (joined pieces
    tokenize to the sum of their tokens): it falls short of its target by
    less than the shortest piece.  A batch's targets spread evenly from
    that much above ``tokens_min`` to ``tokens_max``, the same every batch,
    in an order drawn from the seed."""
    know, _, passages = data.bundled()
    pool = list(passages) + list(know)
    size = [len(tok.ids(piece)) - 2 for piece in pool]
    shortest = min(size)
    r = data.rng(seed, "sections")
    lo = tokens_min + shortest - 1
    targets = np.array([lo + (i * (tokens_max - lo)) // max(batch - 1, 1)
                        for i in range(batch)])
    seen = set()
    while True:
        out = []
        for target in r.permutation(targets):
            while True:
                room, pick = int(target) - 2, []
                for i in r.permutation(len(pool)).tolist():
                    if size[i] <= room:
                        pick.append(i)
                        room -= size[i]
                        if room < shortest:
                            break
                if tuple(pick) not in seen:
                    seen.add(tuple(pick))
                    break
            out.append(("\n\n".join(pool[i] for i in pick), "notes"))
        yield out


def _docs(run, stream: str):
    p = run.params
    return sections(data.torch_seed(run.seed, stream), p["batch"], p["tokens_min"],
                    p["tokens_max"], _tokenizer(run.config))


def _program():
    """The program's DeepSeek-V3 module: a program without one cannot
    serve the configuration, and the run fails here, before any work."""
    from modular_rag_system_tpu_torch.models import deepseek_v3

    return deepseek_v3


def _weights(run):
    """The reference's weights: each tensor drawn on the device from the
    seed when it is asked for."""
    hf = run.config["hf_config"]
    shapes = dict(ref.tensor_shapes(hf))
    seed = data.torch_seed(run.seed, "weights")
    return lambda name: ref.draw(hf, seed, name, shapes[name], run.device)


def _tokenizer(cfg) -> WordPiece:
    return WordPiece(data.minilm_vocab(cfg["hf_config"]["vocab_size"]), cfg["served_len"])


def write_checkpoint(out: Path, cfg: dict, seed: int, device) -> Path:
    """``config.json``, ``vocab.txt`` and ``model.safetensors`` in BF16 under
    the published names, each tensor drawn on ``device`` and written
    before the next is drawn."""
    hf = cfg["hf_config"]
    shapes = ref.tensor_shapes(hf)
    header, offset = {}, 0
    for name, shape in shapes:
        n = 2 * int(np.prod(shape))
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    out.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(out).free
    if free < offset + len(head) + (1 << 30):
        raise RuntimeError(f"the checkpoint needs {(offset + len(head)) / 1e9:.1f} GB; "
                           f"{free / 1e9:.1f} GB are free under {out}")
    (out / "config.json").write_text(json.dumps(hf, indent=1))
    vocab = data.minilm_vocab(hf["vocab_size"])
    (out / "vocab.txt").write_text("".join(p + "\n" for p, _ in
                                           sorted(vocab.items(), key=lambda kv: kv[1])))
    wseed = data.torch_seed(seed, "weights")
    t0 = time.perf_counter()
    with open(out / "model.safetensors", "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for name, shape in shapes:
            t = ref.draw(hf, wseed, name, shape, device).to(torch.bfloat16)
            fh.write(t.view(torch.int16).cpu().numpy().tobytes())
            del t
    log(f"checkpoint: {len(shapes)} tensors, {offset / 1e9:.2f} GB in BF16 written in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def _engine_config(run, ckpt: Path):
    return engines.rag_config(run.config, run.work / "store",
                              {"embedding.hf_checkpoint": str(ckpt)})


def setup(run) -> None:
    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.engine import RAGEngine
    from modular_rag_system_tpu_torch.types import Document

    _program()
    cfg, p = run.config, run.params
    ckpt = write_checkpoint(run.work / "checkpoint", cfg, run.seed, run.device)
    t0 = time.perf_counter()
    eng = RAGEngine(_engine_config(run, ckpt), device=run.device)
    (ckpt / "model.safetensors").unlink()
    log(f"engine: the checkpoint loaded in {time.perf_counter() - t0:.1f} s")
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


def program_pass(enc, calls: List[List[str]], picks: List[int], token_docs: int):
    """The judged documents (``picks``: positions in the calls' flat list,
    ascending) through ``enc`` once more, each in its whole call, as the
    window sent it -> (their unit rows (J, hidden), their experts in each
    expert layer ``[layer][j]`` (n, k), the final hidden states (n,
    hidden) of the first ``token_docs``).  A document alone would route
    differently from its call wherever two experts' scores near-tie (the
    rounding differs with the batch), and one flipped expert moves its
    token's state: a document's rows then differ from its call's by up to
    0.29 (an H100 80GB HBM3)."""
    dsv3 = _program()
    module = enc.module
    seen: Dict[str, object] = {}
    orig = dsv3.route

    def recording(*args, **kwargs):
        idx, w = orig(*args, **kwargs)
        seen["routes"].append(idx)
        return idx, w

    size = len(calls[0]) if calls else 1
    by_call: Dict[int, List[int]] = {}
    for i in picks:
        by_call.setdefault(i // size, []).append(i % size)
    rows: List[torch.Tensor] = []
    routes: List[List[torch.Tensor]] = []
    states: List[torch.Tensor] = []
    hooks = (module.register_forward_pre_hook(lambda m, a: seen.update(mask=a[1])),
             module.final_norm.register_forward_hook(lambda m, a, out: seen.update(h=out)))
    dsv3.route = recording
    try:
        for c in sorted(by_call):
            seen.update(routes=[])
            got = enc.encode_device(calls[c])
            lengths = seen["mask"].sum(1).tolist()[:len(calls[c])]
            cuts = np.cumsum([0] + lengths).tolist()
            for d in by_call[c]:
                s, e = cuts[d], cuts[d + 1]
                rows.append(got[d])
                for j, idx in enumerate(seen["routes"]):
                    if j == len(routes):
                        routes.append([])
                    routes[j].append(idx[s:e])
                if len(states) < token_docs:
                    states.append(seen["h"][s:e].float())
    finally:
        dsv3.route = orig
        for h in hooks:
            h.remove()
    return torch.stack(rows), routes, states


def _numbers(run, rows: List[dict], got=None, precision: str = "f32",
             routes: Optional[list] = None, states: Optional[list] = None) -> Dict[str, float]:
    """``rows`` as ``checks.ingest_numbers`` takes them.  ``row_gap``: the
    widest L2 distance between a stored row (or ``got``'s, or the
    reference's at ``precision``) and the f32 reference's embedding;
    ``token_gap``: over the first ``token_docs`` rows, the widest RMS over
    a document's tokens of the L2 distance between the program's final
    hidden states (``states``, or the reference's at ``precision``) and
    the f32 reference's, over sqrt(hidden) (the states are near unit RMS
    a token); ``route_gap``: the choices of ``routes`` (or of the reference
    at ``precision``) that the f32 reference finds below its tie band;
    ``store_mismatch``: as ``checks.ingest_numbers`` counts it."""
    cfg, dev = run.config, run.device
    hf = cfg["hf_config"]
    ref.no_tf32()
    w, tok = _weights(run), _tokenizer(cfg)
    ids = [ref.ids_of(tok, r["content"], dev) for r in rows]
    td = run.params["token_docs"]
    if not rows:
        return {"row_gap": 0.0, "token_gap": 0.0, "route_gap": 0.0,
                "store_mismatch": float(run.state.get("count_mismatch", 0))}
    if precision != "f32":
        rec: List[List[torch.Tensor]] = []
        c_states, _ = ref.hidden_many(w, hf, ids, precision, record=rec)
        got = torch.stack([ref.pooled(s) for s in c_states])
        routes, states = rec, c_states[:td]
    elif got is None:
        got = torch.stack([torch.as_tensor(r["emb"], dtype=torch.float32) for r in rows])
    want_states, stats = ref.hidden_many(w, hf, ids, follow=routes)
    want = torch.stack([ref.pooled(s) for s in want_states])
    gap = float(torch.linalg.vector_norm(got.to(dev) - want, dim=1).max())
    token_gap = 0.0
    for got_h, want_h in zip(states or [], want_states[:td]):
        if got_h.shape != want_h.shape:
            token_gap = float("inf")
            continue
        d = torch.linalg.vector_norm(got_h.to(dev) - want_h, dim=1)
        token_gap = max(token_gap, float(d.square().mean().sqrt()) / hf["hidden_size"] ** 0.5)
    log(f"routes: {stats['faults']} of {stats['choices']} choices below the tie band")
    mismatch = sum(1 for r in rows if r["stored"] != (r["content"], r["source"])
                   or r["id"] != data.content_id(r["content"], r["source"]))
    mismatch += int(run.state.get("count_mismatch", 0))
    return {"row_gap": gap, "token_gap": token_gap, "route_gap": float(stats["faults"]),
            "store_mismatch": float(mismatch)}


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def release(run) -> None:
    """``ingest``'s read-back; the engine's encoder is kept for ``check``."""
    from portbench.hooks import dense_of

    run.encoder = dense_of(run.engine)
    _INGEST.release(run)


def check(run) -> dict:
    calls = [[c for c, _ in b] for b in run.pool[:run.calls]]
    picks = _INGEST._judged(run, [d for b in calls for d in b])
    t0 = time.perf_counter()
    again, routes, states = program_pass(run.encoder, calls, picks, run.params["token_docs"])
    stored = torch.stack([torch.as_tensor(r["emb"], dtype=torch.float32) for r in run.rows])
    log(f"check: the calls again, rows within "
        f"{float((again.cpu() - stored).abs().max()) if len(stored) else 0.0:.3e} of the stored")
    del again
    run.encoder = None
    _free()
    t1 = time.perf_counter()
    out = _numbers(run, run.rows, routes=routes, states=states)
    log(f"check: the program's pass {t1 - t0:.1f} s, the reference {time.perf_counter() - t1:.1f} s")
    return out


def calibrate(run, precision: str) -> dict:
    """The numbers of ``precision``'s reference in the program's place,
    or of the program's encoder (``"program"``), on the documents a
    window of ``run.seconds`` judges."""
    n = int(np.ceil(CALLS_PER_S * run.seconds))
    calls = [[c for c, _ in b] for b in itertools.islice(_docs(run, "window"), n)]
    docs = [d for b in itertools.islice(_docs(run, "window"), n) for d in b]
    picks = _INGEST._judged(run, docs)
    rows = [{"content": docs[i][0], "source": docs[i][1], "stored": docs[i],
             "id": data.content_id(*docs[i]), "emb": None} for i in picks]
    if precision != "program":
        return _numbers(run, rows, precision=precision)
    from modular_rag_system_tpu_torch.models import build_encoder

    ckpt = write_checkpoint(run.work / "checkpoint", run.config, run.seed, run.device)
    enc = build_encoder(_engine_config(run, ckpt), device=run.device)
    (ckpt / "model.safetensors").unlink()
    got, routes, states = program_pass(enc, calls, picks, run.params["token_docs"])
    del enc
    _free()
    log(f"calibrate: the program's embeddings of {len(rows)} documents")
    return _numbers(run, rows, got=got, routes=routes, states=states)
