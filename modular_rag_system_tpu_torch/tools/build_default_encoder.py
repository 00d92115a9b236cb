"""Build the default encoder's assets with the port: the counterpart of
the JAX package's ``tools/build_default_encoder.py``, same recipe, flags
and ``--smoke`` settings, trained on ``--device`` (default ``cuda``).

Pipeline (everything in-framework, no network):
  1. harvest English sentences from the installed packages
     (``models/corpus.py``),
  2. load the hand-written TRAINING QA pairs (the JAX package's
     ``assets/train/qa_pairs.json``, read as data) and split off a
     HELD-OUT tuning set,
  3. train a WordPiece vocab on the harvested + training text plus the
     knowledge lexicon's vocabulary (``models/lexicon.py``),
  4. train a from-scratch MiniLM-class encoder with ``ContrastiveTrainer``
     on a mixture of: crop/synonym pairs, wh-question-template pairs,
     QA-pair amplifications (alias-substituted variants), synthetic
     paraphrase facts, and raw synonym/alias pairs,
  5. build the lexical statistics (``idf.json``, ``expansion.json``) into
     ``--out`` (``models/lexical.build_lexical_statistics``),
  6. evaluate dense + hybrid (dense|lexical concat) on the HELD-OUT QA
     split — the tuning signal for the lexical mix weight (the external
     eval is never consulted),
  7. write ``--out``: vocab.txt + params.npz (flax keys, f16) + arch.json,
     an asset directory the JAX package loads too.

    python -m modular_rag_system_tpu_torch.tools.build_default_encoder --out DIR
    python -m modular_rag_system_tpu_torch.tools.build_default_encoder --smoke \
        --device cpu --out DIR

``--out`` is required: the port never writes the JAX package's assets.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np


def log(msg):
    print(f"[default-encoder] {msg}", file=sys.stderr, flush=True)


def recall10(encoder, docs, queries, k=10):
    D = np.asarray(encoder.encode(list(docs)), dtype=np.float32)
    Q = np.asarray(encoder.encode(list(queries)), dtype=np.float32)
    D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-9)
    Q /= np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-9)
    s = Q @ D.T
    top = np.argpartition(-s, min(k, s.shape[1] - 1), axis=1)[:, :k]
    return float(np.mean([i in top[i] for i in range(len(queries))]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny corpus/model for CPU smoke runs")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--vocab-size", type=int, default=16384)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heldout-qa", type=int, default=96,
                    help="QA pairs reserved for tuning eval (never trained)")
    ap.add_argument("--out", required=True, help="asset directory to write")
    ap.add_argument("--device", default="cuda",
                    help="device of the trainer and the encoders (cuda or cpu)")
    args = ap.parse_args(argv)

    from modular_rag_system_tpu_torch.models.corpus import (
        _WORDISH,
        _crop,
        _substitute,
        alias_substitute,
        harvest_container_text,
        load_knowledge,
        load_train_qa,
        make_pairs,
        make_question_pairs,
        synonym_table,
        SYNONYMS,
    )
    from modular_rag_system_tpu_torch.models.default_ckpt import (
        check_out_dir,
        save_default_encoder,
    )
    from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
    from modular_rag_system_tpu_torch.models.fake import FeatureHashEncoder
    from modular_rag_system_tpu_torch.models.lexical import (
        ExpansionTable,
        HybridEncoder,
        IdfTable,
        LexicalHashEncoder,
        build_lexical_statistics,
    )
    from modular_rag_system_tpu_torch.models.lexicon import (
        ALIASES,
        vocabulary as lexicon_vocabulary,
    )
    from modular_rag_system_tpu_torch.models.synth import (
        make_paraphrase_corpus,
        recall_at_k,
    )
    from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer
    from modular_rag_system_tpu_torch.models.wordpiece_train import train_wordpiece

    check_out_dir(args.out)  # refuse the JAX package's assets before any work

    if args.smoke:
        args.steps = min(args.steps, 60)
        args.vocab_size = 2048
        max_sent, max_py = 20_000, 800
        n_ent, n_rel = 30, 12
        max_len = 48
    else:
        max_sent, max_py = 300_000, 8_000
        n_ent, n_rel = 120, 50
        max_len = 128

    t0 = time.time()
    sents = harvest_container_text(max_sentences=max_sent, max_py_files=max_py)
    log(f"harvested {len(sents)} sentences in {time.time()-t0:.0f}s")
    rng = random.Random(0)
    rng.shuffle(sents)
    n_eval = min(5000, len(sents) // 10)
    eval_sents, train_sents = sents[:n_eval], sents[n_eval:]

    # hand-written QA pairs: last --heldout-qa are the TUNING set
    qa_q, qa_p = load_train_qa()
    hold = args.heldout_qa if not args.smoke else 32
    # interleave the topic blocks before splitting so the held-out set
    # spans topics (the file is topic-contiguous)
    order = list(range(len(qa_q)))
    random.Random(13).shuffle(order)
    qa_q = [qa_q[i] for i in order]
    qa_p = [qa_p[i] for i in order]
    ho_q, ho_p = qa_q[-hold:], qa_p[-hold:]
    tr_q, tr_p = qa_q[:-hold], qa_p[:-hold]
    log(f"QA pairs: {len(tr_q)} train / {len(ho_q)} held-out")

    # hand-written general-knowledge corpus: the only general-English
    # text in the container — repeat it so WordPiece gives its content
    # vocabulary whole-word pieces despite the much larger harvested set
    knowledge = load_knowledge()
    log(f"knowledge corpus: {len(knowledge)} sentences")

    synth = make_paraphrase_corpus(n_entities=n_ent, n_relations=n_rel,
                                   seed=0)
    vocab_text = (train_sents + synth.docs + synth.train_queries
                  + knowledge * 8 + tr_q + tr_p + lexicon_vocabulary()
                  + [a + " " + b for a, b in SYNONYMS]
                  + [f"{k} {v}" for k, v in ALIASES.items()])
    t0 = time.time()
    vocab = train_wordpiece(vocab_text, vocab_size=args.vocab_size)
    log(f"vocab {len(vocab)} pieces in {time.time()-t0:.0f}s")

    # ---------------- training-pair mixture ---------------------------
    n_pairs = args.steps * args.batch
    qs, ps = [], []

    # 30% harvested crop/synonym pairs (now lexicon-wide synonyms)
    a, b = make_pairs(train_sents, int(n_pairs * 0.30), seed=1)
    qs += a; ps += b
    # 10% wh-question-template pairs over harvested sentences
    a, b = make_question_pairs(train_sents, int(n_pairs * 0.10), seed=2)
    qs += a; ps += b
    # 15% knowledge-corpus crop/synonym pairs (oversampled: this is
    # where the general-English content vocabulary gets grounded)
    a, b = make_pairs(knowledge, int(n_pairs * 0.15), seed=5)
    qs += a; ps += b
    # 15% knowledge-corpus wh-question pairs
    a, b = make_question_pairs(knowledge, int(n_pairs * 0.15), seed=6)
    qs += a; ps += b
    # 20% QA amplification: original pair + alias/synonym variants +
    # question templates over the QA passages
    table = synonym_table()
    arng = random.Random(3)
    qa_pool = []
    for q, p in zip(tr_q, tr_p):
        qa_pool.append((q.lower(), p.lower()))
        qa_pool.append((alias_substitute(q, arng), p.lower()))
        qw = _WORDISH.findall(q.lower())
        if len(qw) >= 4:
            qa_pool.append((_substitute(qw, table, arng, p=0.5), p.lower()))
    tq, tp = make_question_pairs(tr_p, max(len(qa_pool), 1), seed=4)
    qa_pool += list(zip(tq, tp))
    while len(qs) < int(n_pairs * 0.85) and qa_pool:
        q, p = qa_pool[arng.randrange(len(qa_pool))]
        qs.append(q); ps.append(p)
    # ~8% synthetic compositional facts
    synth_q = synth.train_queries
    synth_p = [synth.docs[i] for i in synth.train_doc_idx]
    while len(qs) < n_pairs * 0.93:
        i = rng.randrange(len(synth_q))
        qs.append(synth_q[i]); ps.append(synth_p[i])
    # 10% raw synonym word pairs + alias phrase pairs
    alias_items = list(ALIASES.items())
    while len(qs) < n_pairs:
        if rng.random() < 0.5:
            x, y = SYNONYMS[rng.randrange(len(SYNONYMS))]
        else:
            x, y = alias_items[rng.randrange(len(alias_items))]
        if rng.random() < 0.5:
            x, y = y, x
        qs.append(x); ps.append(y)
    order = list(range(len(qs)))
    rng.shuffle(order)
    qs = [qs[i] for i in order]
    ps = [ps[i] for i in order]
    log(f"{len(qs)} training pairs")

    tok = WordPieceTokenizer(vocab, max_len=max_len)
    arch = dict(num_layers=args.layers, hidden=384, heads=12,
                mlp_dim=1536, vocab_size=len(vocab), max_len=max_len)
    enc = MiniLMEncoder(
        dim=384, max_seq_len=max_len, batch_size=256, dtype="bfloat16",
        num_layers=args.layers, num_heads=12, mlp_dim=1536,
        vocab_size=len(vocab), tokenizer=tok, device=args.device,
    )
    trainer = ContrastiveTrainer(enc, learning_rate=1e-3,
                                 warmup_steps=max(args.steps // 20, 10))

    # held-out English eval: synonym-substituted crops as queries
    erng = random.Random(7)
    e_docs, e_queries = [], []
    for s in eval_sents[:2000]:
        words = _WORDISH.findall(s.lower())
        if len(words) < 6:
            continue
        e_docs.append(s.lower())
        e_queries.append(_substitute(
            _WORDISH.findall(_crop(words, erng)), table, erng))
    log(f"english eval: {len(e_docs)} docs")

    t0 = time.time()
    for step in range(args.steps):
        lo = (step * args.batch) % len(qs)
        hi = lo + args.batch
        loss, acc = trainer.step(qs[lo:hi], ps[lo:hi])
        if step % max(args.steps // 20, 1) == 0:
            log(f"step {step}/{args.steps} loss={loss:.4f} acc={acc:.3f}")
    log(f"trained in {time.time()-t0:.0f}s")
    trainer.sync_encoder()

    # ---------------- IDF and expansion for the lexical encoder -------
    # the shared recipe (models/lexical.build_lexical_statistics) writes
    # idf.json + expansion.json into the asset dir, so this tool and
    # build_lexical_assets can never drift
    lex_stats = build_lexical_statistics(args.out)
    log(f"lexical statistics: {lex_stats}")
    idf = IdfTable.load(str(Path(args.out) / "idf.json"))
    expansion = ExpansionTable.load(str(Path(args.out) / "expansion.json"))

    # ---------------- evaluation (held-out QA tunes the hybrid) -------
    results = {}
    hash_enc = FeatureHashEncoder(dim=384)
    rand_enc = MiniLMEncoder(dim=384, max_seq_len=max_len, batch_size=256,
                             dtype="bfloat16", num_layers=args.layers,
                             num_heads=12, mlp_dim=1536,
                             vocab_size=len(vocab), tokenizer=tok, seed=3,
                             device=args.device)
    for name, e in (("hash", hash_enc), ("random-init", rand_enc),
                    ("trained", enc)):
        results[f"english_recall@10/{name}"] = round(
            recall10(e, e_docs, e_queries), 4)
        results[f"synth_recall@10/{name}"] = round(
            recall_at_k(e, synth, 10), 4)
        results[f"heldout_qa_recall@10/{name}"] = round(
            recall10(e, ho_p, ho_q), 4)
        log(f"{name}: english {results[f'english_recall@10/{name}']} "
            f"synth {results[f'synth_recall@10/{name}']} "
            f"heldoutQA {results[f'heldout_qa_recall@10/{name}']}")

    lex = LexicalHashEncoder(dim=384, idf=idf, expansion=expansion)
    results["heldout_qa_recall@10/lexical"] = round(
        recall10(lex, ho_p, ho_q), 4)
    best_w, best_r = None, -1.0
    for w in (0.3, 0.4, 0.5, 0.6, 0.7, 0.8):
        hyb = HybridEncoder(enc, lex, weight=w)
        r = recall10(hyb, ho_p, ho_q)
        results[f"heldout_qa_recall@10/hybrid_w{w}"] = round(r, 4)
        log(f"hybrid w={w}: heldoutQA {r:.4f}")
        if r > best_r:
            best_w, best_r = w, r
    results["tuned_lexical_weight"] = best_w
    log(f"tuned hybrid weight (held-out QA): {best_w} -> {best_r:.4f}")

    out = save_default_encoder(enc.params, arch, vocab, args.out)
    size_mb = sum(f.stat().st_size for f in Path(out).iterdir()) / 1e6
    log(f"assets written to {out} ({size_mb:.1f} MB)")
    print(json.dumps({"assets": out, "size_mb": round(size_mb, 1),
                      "steps": args.steps, **results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
