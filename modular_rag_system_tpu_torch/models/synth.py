"""Synthetic paraphrase corpus for semantic-retrieval evaluation.

The reference's retrieval quality rests on pretrained embeddings
(``embedding_pipeline.py:424`` real MiniLM forward, ``:363-370`` Ollama
nomic-embed-text).  This zero-egress container has neither, so semantic
quality is *measured* instead of assumed: this module generates a corpus
where lexical matching provably fails and only *learned* semantics can
retrieve — (entity, relation) facts where queries use an entity ALIAS
and a relation PARAPHRASE that share **zero words** with the document.

* each entity has a canonical name (used in documents) and an alias
  (used in queries) with disjoint vocabulary;
* each relation has a document phrasing and a query phrasing, also
  word-disjoint;
* the eval split holds out (entity, relation) COMBINATIONS — every
  entity and every relation appears in training, but the tested pairings
  never do, so recall@k on the eval split measures compositional
  semantic generalization, not memorization.

A hashed-n-gram lexical embedder scores ~chance here (no shared
tokens); an encoder fine-tuned with ``ContrastiveTrainer`` on the train
split must place alias<->canonical and paraphrase<->phrasing nearby to
score at all.  The JAX package's module of the same name; the port's
``tools/build_default_encoder.py`` trains and evaluates on it.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Tuple

_CONS = "bdfgklmnprstvz"
_VOWS = "aeiou"


def _word_maker(rng: random.Random):
    """Unique pronounceable pseudo-words (2-3 syllables)."""
    seen = set()

    def make() -> str:
        while True:
            n_syll = rng.choice((2, 3))
            w = "".join(
                rng.choice(_CONS) + rng.choice(_VOWS) for _ in range(n_syll)
            )
            if w not in seen:
                seen.add(w)
                return w

    return make


@dataclass
class ParaphraseCorpus:
    """(entity, relation) fact corpus with word-disjoint query paraphrases."""

    docs: List[str]
    train_queries: List[str]
    train_doc_idx: List[int]
    eval_queries: List[str]
    eval_doc_idx: List[int]
    entities: List[Tuple[str, str]] = field(default_factory=list)  # (canonical, alias)
    relations: List[Tuple[str, str]] = field(default_factory=list)  # (doc phr, query phr)


def make_paraphrase_corpus(
    n_entities: int = 40,
    n_relations: int = 25,
    train_frac: float = 0.8,
    phrase_words: int = 3,
    name_words: int = 2,
    seed: int = 0,
    hardness: float = 0.0,
    facts_per_doc: int = 1,
) -> ParaphraseCorpus:
    """``hardness`` in [0, 1) de-saturates the eval (VERDICT r2 item 9):

    * 0.0 — every alias/paraphrase word is globally unique (the r2
      corpus; trained encoders hit recall 1.0 at tested scales).
    * > 0 — alias/query-phrasing AND canonical-name/doc-phrasing words
      are drawn from SHARED pools (one per slot) whose size shrinks
      with hardness: different entities' aliases collide on words
      (near-alias distractors), relations' phrasings overlap
      (same-entity/different-relation confusion), and — r3.4 —
      distractor DOCUMENTS become near-duplicates of the gold (same
      words, different combination), so retrieval must make
      fine-grained distinctions.  Query-vs-document vocabulary stays
      fully disjoint (separate pools) — lexical matching still scores
      ~chance; hardness only makes the SEMANTIC discrimination
      finer-grained.

    ``facts_per_doc`` > 1 packs several different entities' facts into
    one document (multi-fact documents): the gold document for a query
    also scores on its other facts' vocabulary, adding retrieval-side
    distraction."""
    rng = random.Random(seed)
    word = _word_maker(rng)

    def shared_pool(n_unique_words: int):
        # pool size interpolates: hardness 0 -> unique words per slot,
        # hardness -> 1 shrinks toward a handful of shared words
        if hardness <= 0.0:
            return None
        size = max(4, int(round(n_unique_words * (1.0 - hardness))))
        return [word() for _ in range(size)]

    alias_pool = shared_pool(n_entities * name_words)
    qphr_pool = shared_pool(n_relations * phrase_words)
    # hardness also collides the DOCUMENT side (r3.4): canonical names
    # and doc phrasings draw from their own shared pools, so distractor
    # documents become near-duplicates of the gold (same words, different
    # combination) and retrieval must make fine-grained distinctions —
    # without this, docs are globally unique-vocab and recall saturates
    # at any corpus size the trainer can fit.  Query/doc vocabulary
    # remains fully disjoint (separate pools).
    cname_pool = shared_pool(n_entities * name_words)
    dphr_pool = shared_pool(n_relations * phrase_words)
    seen_cname: set = set()
    seen_dphr: set = set()

    def draw(pool, n):
        if pool is None:
            return " ".join(word() for _ in range(n))
        return " ".join(rng.choice(pool) for _ in range(n))

    seen_alias: set = set()
    seen_qphr: set = set()

    def unique_draw(pool, n, seen):
        # distinct surface forms even under heavy word sharing, so two
        # entities never become literally indistinguishable
        for _ in range(64):
            s = draw(pool, n)
            if s not in seen:
                seen.add(s)
                return s
        s = draw(None, n)
        seen.add(s)
        return s

    entities = [
        (
            unique_draw(cname_pool, name_words, seen_cname),
            unique_draw(alias_pool, name_words, seen_alias),
        )
        for _ in range(n_entities)
    ]
    relations = [
        (
            unique_draw(dphr_pool, phrase_words, seen_dphr),
            unique_draw(qphr_pool, phrase_words, seen_qphr),
        )
        for _ in range(n_relations)
    ]

    facts = [(e, r) for e in range(n_entities) for r in range(n_relations)]
    fact_text = [f"{entities[e][0]} {relations[r][0]}" for e, r in facts]
    queries = [f"{entities[e][1]} {relations[r][1]}" for e, r in facts]

    if facts_per_doc <= 1:
        docs = fact_text
        fact_doc = list(range(len(facts)))
    else:
        # pack consecutive shuffled facts into multi-fact documents
        pack = list(range(len(facts)))
        rng.shuffle(pack)
        docs = []
        fact_doc = [0] * len(facts)
        for d_i, lo in enumerate(range(0, len(pack), facts_per_doc)):
            group = pack[lo : lo + facts_per_doc]
            docs.append(". ".join(fact_text[i] for i in group))
            for i in group:
                fact_doc[i] = d_i

    order = list(range(len(facts)))
    rng.shuffle(order)
    n_train = int(len(facts) * train_frac)
    train, evals = order[:n_train], order[n_train:]
    return ParaphraseCorpus(
        docs=docs,
        train_queries=[queries[i] for i in train],
        train_doc_idx=[fact_doc[i] for i in train],
        eval_queries=[queries[i] for i in evals],
        eval_doc_idx=[fact_doc[i] for i in evals],
        entities=entities,
        relations=relations,
    )


def recall_at_k(encoder, corpus: ParaphraseCorpus, k: int = 10) -> float:
    """recall@k of the gold document for the held-out paraphrase queries.

    Encodes with the given encoder (any object with ``encode``) and
    scores by cosine via a plain matmul — small corpora only."""
    import numpy as np

    D = np.asarray(encoder.encode(corpus.docs), dtype=np.float32)
    Qm = np.asarray(encoder.encode(corpus.eval_queries), dtype=np.float32)
    D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-9)
    Qm /= np.maximum(np.linalg.norm(Qm, axis=1, keepdims=True), 1e-9)
    scores = Qm @ D.T
    topk = np.argpartition(-scores, min(k, scores.shape[1] - 1), axis=1)[:, :k]
    hits = sum(
        1 for qi, gold in enumerate(corpus.eval_doc_idx) if gold in topk[qi]
    )
    return hits / len(corpus.eval_doc_idx)
