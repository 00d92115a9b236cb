"""Lexical hash encoder + hybrid dense/lexical embedding (host side).

* ``LexicalHashEncoder`` — IDF-weighted, stemmed, lexicon-canonicalized
  bag of words, signed-hashed into a fixed-dim L2-normalized vector.
  Pure numpy, value for value the JAX package's encoder; its statistics
  (``idf.json``, ``expansion.json``) are read from the bundled asset
  directory (``models.default_ckpt.ASSET_DIR``).  ``IdfTable.from_texts``,
  ``ExpansionTable.from_texts`` and ``build_lexical_statistics`` rebuild
  them (into a directory of the caller's, never the bundled one).
* ``HybridEncoder`` — ``[sqrt(1-w) * dense_unit | sqrt(w) * lexical_unit]``:
  cosine of the concat is the weighted sum of the two cosines, so every
  index tier works unchanged on hybrid embeddings.
"""

from __future__ import annotations

import json
import math
import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from modular_rag_system_tpu_torch.models.default_ckpt import ASSET_DIR, check_out_dir

_WORD = re.compile(r"[a-z][a-z'-]*")

# Function words excluded from lexical features (queries are mostly
# scaffolding: "why does the ... always ...").  Kept separate from the
# engine's snippet stopwords — this list is part of the embedding
# definition and must stay stable across versions.
STOPWORDS = frozenset("""
a an the of to in on for and or nor but is are was were be been being am
does do did done doing why how what which when who whom whose where whether
with without from into onto over under between among through during while
its it their they them your you my i we our us his her he she him this that
these those there here then than as by at if so such very much many most
more less few fewer some any all each every either neither one ones other
another like unlike about above below across behind beyond near far out up
down off not no yes can could should would will shall may might must ought
have has had having get gets got getting make makes made making go goes
went gone going come comes came coming take takes took taken taking
also just only even still yet again once twice always never ever often
sometimes usually now today currently something anything nothing everything
someone anyone everyone somebody anybody nobody called named known certain
actually really quite rather too enough both around along upon within
""".split())


def fnv1a(s: str) -> int:
    """Deterministic 64-bit FNV-1a (Python's ``hash`` is salted per
    process — useless for embeddings that must be stable on disk)."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


# words ending in -s that are NOT plurals (stripping would corrupt)
_S_EXCEPTIONS = frozenset((
    "lens", "gas", "bus", "atlas", "bonus", "virus", "census", "chaos",
    "cosmos", "iris", "pelvis", "basis", "crisis", "tennis", "alias",
    "bias", "canvas", "circus", "citrus", "focus", "fungus", "genius",
    "campus", "status", "physics", "mathematics", "news", "series",
    "species", "diabetes", "rabies", "measles", "molasses", "always",
    "perhaps", "whereas", "plus", "versus", "thus",
))

_DERIV_SUFFIXES = (
    # order matters: longest first.  -er/-est are deliberately ABSENT:
    # stripping them corrupts common nouns (forest -> for, spider ->
    # spid) for the rare benefit of matching comparatives.
    "ization", "ations", "ation", "ingly", "ising", "izing",
    "ings", "ment", "ness", "ing", "edly", "ied", "ily", "ed", "ly",
)


def light_stem(word: str) -> str:
    """Rule-based suffix stripper (Porter-lite).

    Deliberately conservative: handles plural -s (with a non-plural
    exception list and -ies -> y), common verbal/derivational endings,
    consonant undoubling (dimm -> dim), and a final silent-e strip so
    "rise"/"rising" collide.  The goal is collision of inflectional
    variants, not linguistic perfection — the same rules apply to query
    and document, so stems only need to be consistent."""
    w = word
    if len(w) <= 3:
        return w
    if w in _S_EXCEPTIONS:
        return w
    # plural endings first
    if w.endswith("ies") and len(w) >= 5:
        w = w[:-3] + "y"
    elif w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("es") and len(w) >= 5 and w[-3] in "sxz":
        w = w[:-2]  # boxes, classes, quizzes
    elif w.endswith("s") and not w.endswith(("ss", "us", "is")):
        w = w[:-1]
    for suf in _DERIV_SUFFIXES:
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: len(w) - len(suf)]
            break
    # undouble final consonant: "dimm" -> "dim", "runn" -> "run"
    if len(w) >= 4 and w[-1] == w[-2] and w[-1] not in "aeiouls":
        w = w[:-1]
    # final silent e: "rise" -> "ris" (matches "rising" -> "ris")
    if len(w) >= 4 and w.endswith("e"):
        w = w[:-1]
    return w


def _words(text: str) -> List[str]:
    return _WORD.findall(text.lower())


class _Canonicalizer:
    """Shared token -> canonical-feature mapping built from
    ``models.lexicon`` (synsets + multiword aliases)."""

    _singleton: Optional["_Canonicalizer"] = None

    def __init__(self) -> None:
        from modular_rag_system_tpu_torch.models.lexicon import (
            alias_map,
            canonical_word_map,
        )

        cmap = canonical_word_map()
        # stem -> stemmed canonical head (both sides stemmed so that
        # inflections of a synonym still canonicalize)
        self.canon: Dict[str, str] = {}
        for w, head in cmap.items():
            self.canon.setdefault(light_stem(w), light_stem(head))
        self.alias: Dict[tuple, str] = {}
        self.max_alias_len = 1
        for surface, target in alias_map().items():
            key = tuple(surface.split())
            self.alias[key] = light_stem(target)
            self.max_alias_len = max(self.max_alias_len, len(key))

    @classmethod
    def get(cls) -> "_Canonicalizer":
        if cls._singleton is None:
            cls._singleton = cls()
        return cls._singleton

    def features(self, text: str) -> List[str]:
        """Canonical feature stream: greedy longest-match alias
        detection over the raw word stream (aliases may contain
        stopwords), then stopword-filter + stem + synset-canonicalize
        the remainder."""
        words = _words(text)
        out: List[str] = []
        i, n = 0, len(words)
        while i < n:
            matched = False
            for ln in range(min(self.max_alias_len, n - i), 1, -1):
                tgt = self.alias.get(tuple(words[i : i + ln]))
                if tgt is not None:
                    out.append(self.canon.get(tgt, tgt))
                    i += ln
                    matched = True
                    break
            if matched:
                continue
            w = words[i]
            i += 1
            if w in STOPWORDS:
                continue
            s = light_stem(w)
            # single-word aliases ride the same table
            tgt = self.alias.get((w,))
            if tgt is not None:
                s = tgt
            out.append(self.canon.get(s, s))
        return out


class IdfTable:
    """stem -> inverse document frequency, built from a corpus once and
    shipped as a JSON asset (language-level statistics, NOT per-index:
    embeddings must not change when the corpus grows)."""

    def __init__(self, idf: Dict[str, float], default: float) -> None:
        self.idf = idf
        self.default = default

    @classmethod
    def from_texts(cls, texts: Iterable[str], max_terms: int = 60_000) -> "IdfTable":
        df: Counter = Counter()
        n_docs = 0
        feats = _Canonicalizer.get().features
        for t in texts:
            n_docs += 1
            df.update(set(feats(t)))
        idf = {
            w: round(math.log((n_docs + 1) / (c + 0.5)), 3)
            for w, c in df.most_common(max_terms)
        }
        default = round(math.log((n_docs + 1) / 0.5), 3)
        return cls(idf, default)

    def save(self, path: str) -> None:
        Path(path).write_text(
            json.dumps({"default": self.default, "idf": self.idf}))

    @classmethod
    def load(cls, path: str) -> "IdfTable":
        data = json.loads(Path(path).read_text())
        return cls({k: float(v) for k, v in data["idf"].items()},
                   float(data["default"]))

    def __call__(self, stem: str) -> float:
        return self.idf.get(stem, self.default)


_BUNDLED_IDF = ASSET_DIR / "idf.json"
_BUNDLED_EXPANSION = ASSET_DIR / "expansion.json"


class ExpansionTable:
    """stem -> [(related stem, strength 0..1)] from corpus co-occurrence.

    Distributional semantics as DATA: pointwise mutual information over
    sentence co-occurrence in the training corpora (knowledge sentences
    + harvested English) links words the hand lexicon cannot enumerate
    ("eclipse"~"shadow", "yeast"~"dough").  Expanding a text's features
    with its stems' top partners at a sub-unit weight gives the lexical
    encoder a soft-match term — the same mechanism word embeddings
    learn, derived from the same corpora, but inspectable."""

    def __init__(self, table: Dict[str, list]) -> None:
        self.table = table

    @classmethod
    def from_texts(cls, texts: Iterable[str], min_count: int = 3,
                   min_pmi: float = 1.0, top_partners: int = 16
                   ) -> "ExpansionTable":
        # defaults tuned on the held-out QA split (round 5): wider
        # partner lists at a lower PMI floor beat few-strong-partners
        # (0.53 -> 0.66 held-out recall@10)
        from collections import defaultdict

        cnt: Counter = Counter()
        co: Dict[str, Counter] = defaultdict(Counter)
        feats = _Canonicalizer.get().features
        n_docs = 0
        for t in texts:
            fs = sorted(set(feats(t)))
            n_docs += 1
            for i, a in enumerate(fs):
                cnt[a] += 1
                for b in fs[i + 1:]:
                    co[a][b] += 1
        table: Dict[str, list] = {}
        for a, partners in co.items():
            if cnt[a] < min_count:
                continue
            for b, c_ab in partners.items():
                if cnt[b] < min_count or c_ab < 2:
                    continue
                pmi = math.log(c_ab * n_docs / (cnt[a] * cnt[b]))
                if pmi <= min_pmi:
                    continue
                w = round(min(pmi / 3.0, 1.0), 3)
                table.setdefault(a, []).append((b, w))
                table.setdefault(b, []).append((a, w))
        for a in table:
            table[a] = sorted(table[a], key=lambda x: -x[1])[:top_partners]
        return cls(table)

    def save(self, path: str) -> None:
        Path(path).write_text(json.dumps(self.table))

    @classmethod
    def load(cls, path: str) -> "ExpansionTable":
        raw = json.loads(Path(path).read_text())
        return cls({k: [(b, float(w)) for b, w in v] for k, v in raw.items()})

    def partners(self, stem: str):
        return self.table.get(stem, ())


class LexicalHashEncoder:
    """Deterministic sparse-to-dense lexical embedding.

    encode(texts) -> (n, dim) float32, L2-normalized.  Three feature
    families share the signed-hash space (weights tuned on the held-out
    QA split, never the external eval):

    * canonical stems — weight (1 + log tf) * idf: BM25's heart;
    * char 4-grams of each stem — weight ``subword_weight * idf / n``:
      morphology the rule stemmer can't collapse (buoyant~buoyancy);
    * expansion partners — weight ``expansion_weight * idf_b * pmi``:
      corpus co-occurrence neighbors (ExpansionTable), the soft
      distributional-match term.

    Cosine of two vectors then approximates a weighted lexical+
    morphological+topical overlap score, in a form every index tier
    already understands."""

    def __init__(self, dim: int = 384, idf: Optional[IdfTable] = None,
                 expansion: Optional[ExpansionTable] = None,
                 subword_weight: float = 0.8,
                 expansion_weight: float = 0.5,
                 subword_n: int = 4,
                 name: str = "lexical-hash") -> None:
        self.dim = int(dim)
        # the bundled statistics must load: a missing asset raises
        # rather than quietly changing what the embedding means
        self.idf = idf or IdfTable.load(str(_BUNDLED_IDF))
        self.expansion = (expansion if expansion is not None
                          else ExpansionTable.load(str(_BUNDLED_EXPANSION)))
        self.subword_weight = float(subword_weight)
        self.expansion_weight = float(expansion_weight)
        self.subword_n = int(subword_n)
        self.name = f"{name}-{dim}"
        self._canon = _Canonicalizer.get()
        # Per-stem contribution cache (round-5 ingest fix): a stem's
        # n-gram and expansion features are FIXED, so its full sparse
        # vector is computed once and replayed as two numpy scatters.
        # The uncached Python loops measured 460 chunks/s at 100k-row
        # ingest on chip — a 45x regression vs the dense-only path.
        # Bounded: past the cap, contributions are computed uncached
        # (arbitrary user text mints unbounded unique stems — UUIDs,
        # identifiers — and a long-lived server must not leak host RAM).
        self._stem_cache: Dict[str, tuple] = {}
        self._STEM_CACHE_MAX = 262_144

    def _stem_contrib(self, w: str):
        """(own_idx, own_val, rest_idx, rest_val): the stem's own
        bucket (to be scaled by the tf factor) and its fixed n-gram +
        expansion contributions."""
        c = self._stem_cache.get(w)
        if c is not None:
            return c
        idf_w = self.idf(w)
        own_idx = np.array([fnv1a(w) % self.dim], np.int64)
        own_val = np.array(
            [(1.0 if (fnv1a(w + "\x01") & 1) else -1.0) * idf_w],
            np.float32)
        r_idx: list = []
        r_val: list = []
        if self.subword_weight > 0.0:
            padded = "^" + w + "$"
            n_spans = max(len(padded) - self.subword_n + 1, 1)
            sub_w = self.subword_weight * idf_w / n_spans
            for j in range(n_spans):
                g = padded[j:j + self.subword_n]
                r_idx.append(fnv1a("#g" + g) % self.dim)
                r_val.append(
                    (1.0 if (fnv1a(g + "\x02") & 1) else -1.0) * sub_w)
        if self.expansion is not None and self.expansion_weight > 0.0:
            for b, strength in self.expansion.partners(w):
                r_idx.append(fnv1a(b) % self.dim)
                r_val.append(
                    (1.0 if (fnv1a(b + "\x01") & 1) else -1.0)
                    * self.expansion_weight * self.idf(b) * strength)
        c = (own_idx, own_val,
             np.asarray(r_idx, np.int64), np.asarray(r_val, np.float32))
        if len(self._stem_cache) < self._STEM_CACHE_MAX:
            self._stem_cache[w] = c
        return c

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            c = Counter(self._canon.features(t))
            if not c:
                continue
            idx_parts: list = []
            val_parts: list = []
            for w, n in c.items():
                own_idx, own_val, r_idx, r_val = self._stem_contrib(w)
                tf = 1.0 + math.log(n)
                idx_parts.append(own_idx)
                val_parts.append(tf * own_val)
                if r_idx.size:
                    idx_parts.append(r_idx)
                    val_parts.append(r_val)
            np.add.at(out[i], np.concatenate(idx_parts),
                      np.concatenate(val_parts))
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.maximum(norms, 1e-9, out=norms)
        out /= norms
        return out


def build_lexical_statistics(out_dir, max_sentences: int = 120_000,
                             max_py_files: int = 8_000) -> dict:
    """Build and save the lexical statistics (``idf.json`` and
    ``expansion.json``) from the canonical corpus mix into ``out_dir``.

    The single recipe both ``tools/build_lexical_assets.py`` and
    ``tools/build_default_encoder.py`` call, so the two assets cannot
    drift from each other or from the feature definition above.  Unlike
    the JAX package's, ``out_dir`` is required: the bundled directory is
    read-only here."""
    import random

    from modular_rag_system_tpu_torch.models.corpus import (
        harvest_container_text,
        load_knowledge,
        load_train_qa,
    )

    d = check_out_dir(out_dir)
    know = load_knowledge()
    _, qa_p = load_train_qa()
    harv = harvest_container_text(max_sentences=max_sentences,
                                  max_py_files=max_py_files)
    # training passages only — the held-out tail (96, split seed 13 in
    # the build tools) must not inform the statistics it tunes against
    order = list(range(len(qa_p)))
    random.Random(13).shuffle(order)
    tr_p = [qa_p[i] for i in order][:-96]

    idf = IdfTable.from_texts(harv + know + tr_p)
    exp = ExpansionTable.from_texts(know * 4 + tr_p + harv)
    d.mkdir(parents=True, exist_ok=True)
    idf.save(str(d / "idf.json"))
    exp.save(str(d / "expansion.json"))
    return {"idf_terms": len(idf.idf),
            "expansion_entries": len(exp.table),
            "corpora": {"knowledge": len(know), "qa_train": len(tr_p),
                        "harvested": len(harv)},
            "asset_dir": str(d)}


class HybridEncoder:
    """[sqrt(1-w) * dense_unit | sqrt(w) * lexical_unit] concatenation.

    cos(hybrid_a, hybrid_b) = (1-w)*cos(dense) + w*cos(lex) and the
    hybrid vector is unit-norm by construction, so similarity
    thresholds keep their meaning.  ``dim`` is the concatenated width —
    the engine sizes its index from the ENCODER's dim (one-encoder
    contract), so hybrid needs no special support anywhere downstream."""

    def __init__(self, dense, lexical: LexicalHashEncoder,
                 weight: float = 0.5) -> None:
        if not 0.0 < weight < 1.0:
            raise ValueError(f"hybrid weight must be in (0,1), got {weight}")
        self.dense = dense
        self.lexical = lexical
        self.weight = float(weight)
        self.dim = int(getattr(dense, "dim")) + lexical.dim
        self.name = (f"hybrid({getattr(dense, 'name', 'dense')}"
                     f"+{lexical.name}, w={weight})")
        # chunker integration: token counting follows the dense side
        tc = getattr(dense, "token_count", None)
        if tc is not None:
            self.token_count = tc

    @property
    def tokenizer(self):
        """The dense side's tokenizer (chunker/stats integration)."""
        return getattr(self.dense, "tokenizer", None)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        D = np.asarray(self.dense.encode(list(texts)), np.float32)
        norms = np.linalg.norm(D, axis=1, keepdims=True)
        np.maximum(norms, 1e-9, out=norms)
        D = D / norms
        L = self.lexical.encode(texts)
        wd = math.sqrt(1.0 - self.weight)
        wl = math.sqrt(self.weight)
        return np.concatenate([wd * D, wl * L], axis=1)

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)

    def encode_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Bulk-ingest path: the dense forward stays on the device and
        only the host-computed lexical half is uploaded.  The dense rows
        are already unit-norm (``SentenceEncoderModule`` normalizes), so
        they are not re-normalized here, unlike ``encode``."""
        D = self.dense.encode_device(texts)  # (n, dense_dim) f32
        L = torch.from_numpy(self.lexical.encode(texts)).to(D.device)
        wd = math.sqrt(1.0 - self.weight)
        wl = math.sqrt(self.weight)
        return torch.cat([wd * D, wl * L], dim=1)
