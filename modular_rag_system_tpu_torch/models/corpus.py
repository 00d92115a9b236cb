"""Zero-egress English training corpus for the bundled default encoder.

The reference shipped working semantics out of the box by downloading a
pretrained model (``embedding_pipeline.py:424`` sentence-transformers
MiniLM).  This container has no egress, so the default checkpoint is
TRAINED IN-FRAMEWORK (VERDICT r2 item 3) on text that is already here:

* **Harvested English** — documentation files (*.md/*.rst/*.txt) and
  module/class/function docstrings from the installed site-packages +
  stdlib: tens of MB of real English prose, filtered by a
  natural-language heuristic.
* **A hand-authored synonym lexicon** (``SYNONYMS`` below) mapping
  common English words to their synonyms.  Substituting synonyms into
  one side of a training pair teaches the encoder genuine English
  synonymy — the part of "semantic" retrieval that pure lexical overlap
  can never provide.
* **Compositional pseudo-word facts** (``models.synth``) whose
  alias/paraphrase structure forces non-lexical matching.

Pairs for the contrastive objective: two different crops (with word
dropout) of one sentence, query-side synonym substitution, plus the
synthetic alias facts.

The JAX package's module of the same name, pair for pair; the bundled
training files are read as data from that package's
``assets/train/`` directory.
"""

from __future__ import annotations

import ast
import functools
import os
import random
import re
import sys
import sysconfig
from typing import Dict, Iterable, List, Sequence, Tuple

from modular_rag_system_tpu_torch.models.default_ckpt import ASSET_DIR
from modular_rag_system_tpu_torch.models.lexicon import ALIASES, SYNSETS

_TRAIN_DIR = ASSET_DIR.parent / "train"

# ---------------------------------------------------------------------------
# hand-authored synonym lexicon (common English; both directions are used)
SYNONYMS: List[Tuple[str, str]] = [
    ("big", "large"), ("big", "huge"), ("small", "little"), ("small", "tiny"),
    ("fast", "quick"), ("fast", "rapid"), ("slow", "sluggish"),
    ("begin", "start"), ("begin", "commence"), ("end", "finish"),
    ("end", "conclude"), ("stop", "halt"), ("make", "create"),
    ("make", "build"), ("build", "construct"), ("destroy", "demolish"),
    ("buy", "purchase"), ("sell", "vend"), ("get", "obtain"),
    ("get", "acquire"), ("give", "provide"), ("give", "supply"),
    ("show", "display"), ("show", "present"), ("hide", "conceal"),
    ("find", "locate"), ("find", "discover"), ("search", "seek"),
    ("look", "glance"), ("see", "observe"), ("watch", "view"),
    ("say", "state"), ("say", "declare"), ("tell", "inform"),
    ("ask", "inquire"), ("answer", "reply"), ("answer", "respond"),
    ("help", "assist"), ("help", "aid"), ("need", "require"),
    ("want", "desire"), ("use", "utilize"), ("use", "employ"),
    ("keep", "retain"), ("hold", "grasp"), ("take", "grab"),
    ("choose", "select"), ("choose", "pick"), ("decide", "determine"),
    ("change", "modify"), ("change", "alter"), ("fix", "repair"),
    ("fix", "mend"), ("break", "shatter"), ("cut", "slice"),
    ("join", "connect"), ("join", "combine"), ("split", "divide"),
    ("move", "shift"), ("move", "relocate"), ("carry", "transport"),
    ("send", "transmit"), ("receive", "accept"), ("store", "save"),
    ("delete", "remove"), ("delete", "erase"), ("add", "append"),
    ("add", "insert"), ("count", "tally"), ("measure", "gauge"),
    ("check", "verify"), ("check", "inspect"), ("test", "examine"),
    ("error", "mistake"), ("error", "fault"), ("problem", "issue"),
    ("problem", "difficulty"), ("question", "query"),
    ("answer", "solution"), ("result", "outcome"), ("reason", "cause"),
    ("goal", "objective"), ("goal", "aim"), ("task", "job"),
    ("work", "labor"), ("method", "technique"), ("method", "approach"),
    ("way", "manner"), ("idea", "concept"), ("idea", "notion"),
    ("plan", "scheme"), ("rule", "regulation"), ("law", "statute"),
    ("part", "portion"), ("part", "section"), ("whole", "entire"),
    ("many", "numerous"), ("few", "scarce"), ("more", "additional"),
    ("enough", "sufficient"), ("empty", "vacant"), ("full", "complete"),
    ("new", "novel"), ("new", "recent"), ("old", "ancient"),
    ("old", "aged"), ("young", "youthful"), ("modern", "contemporary"),
    ("good", "excellent"), ("good", "fine"), ("bad", "poor"),
    ("bad", "terrible"), ("great", "wonderful"), ("nice", "pleasant"),
    ("happy", "glad"), ("happy", "joyful"), ("sad", "unhappy"),
    ("angry", "furious"), ("afraid", "scared"), ("calm", "peaceful"),
    ("easy", "simple"), ("hard", "difficult"), ("hard", "tough"),
    ("strong", "powerful"), ("weak", "feeble"), ("heavy", "weighty"),
    ("light", "bright"), ("dark", "dim"), ("clean", "spotless"),
    ("dirty", "filthy"), ("wet", "damp"), ("dry", "arid"),
    ("hot", "warm"), ("cold", "chilly"), ("cold", "frigid"),
    ("rich", "wealthy"), ("poor", "impoverished"), ("cheap", "inexpensive"),
    ("expensive", "costly"), ("important", "significant"),
    ("important", "crucial"), ("main", "primary"), ("main", "principal"),
    ("true", "correct"), ("true", "accurate"), ("false", "wrong"),
    ("false", "incorrect"), ("real", "genuine"), ("fake", "counterfeit"),
    ("same", "identical"), ("different", "distinct"),
    ("similar", "alike"), ("strange", "odd"), ("strange", "unusual"),
    ("common", "ordinary"), ("rare", "uncommon"), ("special", "unique"),
    ("whole", "total"), ("quiet", "silent"), ("loud", "noisy"),
    ("smart", "clever"), ("smart", "intelligent"), ("stupid", "foolish"),
    ("brave", "courageous"), ("careful", "cautious"),
    ("dangerous", "hazardous"), ("safe", "secure"),
    ("fast", "speedy"), ("beautiful", "pretty"), ("ugly", "hideous"),
    ("famous", "renowned"), ("car", "automobile"), ("car", "vehicle"),
    ("road", "street"), ("house", "home"), ("house", "dwelling"),
    ("city", "town"), ("country", "nation"), ("world", "globe"),
    ("sea", "ocean"), ("forest", "woods"), ("mountain", "peak"),
    ("river", "stream"), ("rock", "stone"), ("earth", "ground"),
    ("sky", "heavens"), ("rain", "rainfall"), ("wind", "breeze"),
    ("storm", "tempest"), ("fire", "blaze"), ("doctor", "physician"),
    ("teacher", "instructor"), ("student", "pupil"), ("child", "kid"),
    ("friend", "companion"), ("enemy", "foe"), ("leader", "chief"),
    ("boss", "manager"), ("worker", "employee"), ("money", "cash"),
    ("money", "currency"), ("price", "cost"), ("shop", "store"),
    ("food", "nourishment"), ("meal", "dinner"), ("drink", "beverage"),
    ("illness", "disease"), ("illness", "sickness"), ("medicine", "drug"),
    ("pain", "ache"), ("body", "physique"), ("mind", "intellect"),
    ("talk", "speak"), ("talk", "converse"), ("walk", "stroll"),
    ("run", "sprint"), ("jump", "leap"), ("throw", "toss"),
    ("pull", "drag"), ("push", "shove"), ("lift", "raise"),
    ("fall", "drop"), ("rise", "ascend"), ("sleep", "slumber"),
    ("eat", "consume"), ("laugh", "chuckle"), ("cry", "weep"),
    ("think", "ponder"), ("think", "consider"), ("know", "understand"),
    ("learn", "study"), ("teach", "instruct"), ("remember", "recall"),
    ("forget", "overlook"), ("believe", "trust"), ("hope", "wish"),
    ("love", "adore"), ("hate", "despise"), ("like", "enjoy"),
    ("fear", "dread"), ("surprise", "astonish"), ("begin", "initiate"),
    ("finish", "complete"), ("continue", "proceed"), ("wait", "pause"),
    ("hurry", "rush"), ("arrive", "reach"), ("leave", "depart"),
    ("enter", "access"), ("exit", "leave"), ("open", "unlock"),
    ("close", "shut"), ("fill", "load"), ("cover", "wrap"),
    ("protect", "defend"), ("attack", "assault"), ("win", "triumph"),
    ("lose", "forfeit"), ("fight", "battle"), ("agree", "concur"),
    ("refuse", "decline"), ("allow", "permit"), ("forbid", "prohibit"),
    ("order", "command"), ("obey", "comply"), ("gather", "collect"),
    ("spread", "distribute"), ("share", "divide"), ("own", "possess"),
    ("earn", "gain"), ("spend", "expend"), ("waste", "squander"),
    ("grow", "expand"), ("shrink", "contract"), ("increase", "enlarge"),
    ("decrease", "reduce"), ("improve", "enhance"), ("worsen", "degrade"),
]


def synonym_table() -> Dict[str, List[str]]:
    """word -> synonyms mapping (both directions).

    Round 5: merged with the much larger hand-authored lexicon
    (``models.lexicon.SYNSETS``) so the trained encoder and the lexical
    hash encoder learn/share the SAME synonymy."""
    table: Dict[str, List[str]] = {}
    for a, b in SYNONYMS:
        table.setdefault(a, []).append(b)
        table.setdefault(b, []).append(a)
    for group in SYNSETS:
        for w in group:
            entry = table.setdefault(w, [])
            entry.extend(x for x in group if x != w and x not in entry)
    return table


def load_knowledge() -> List[str]:
    """Hand-written general-knowledge sentences
    (assets/train/knowledge.json): the only general-English text in a
    zero-egress container (site-packages prose is purely technical).
    Grounds the from-scratch encoder's content vocabulary; eval-leak
    filtered at merge time and tested disjoint."""
    import json

    return list(json.loads((_TRAIN_DIR / "knowledge.json").read_text())["sentences"])


def load_train_qa():
    """Hand-written TRAINING QA pairs (assets/train/qa_pairs.json).

    Returns (queries, passages) — fact-disjoint from the external eval
    by authorship discipline (enforced by tests/test_external_eval.py).
    Used as direct QA-style contrastive supervision and as the held-out
    tuning set for the hybrid mix weight."""
    import json

    data = json.loads((_TRAIN_DIR / "qa_pairs.json").read_text())
    items = data["items"]
    return ([it["query"] for it in items],
            [it["passage"] for it in items])


@functools.lru_cache(maxsize=None)
def _alias_bidir() -> Dict[str, List[str]]:
    """Both directions of the lexicon's aliases, built once a process."""
    fwd: Dict[str, List[str]] = {}
    for surface, target in ALIASES.items():
        fwd.setdefault(surface, []).append(target)
        fwd.setdefault(target, []).append(surface)
    return fwd


def alias_substitute(text: str, rng: random.Random, p: float = 0.7) -> str:
    """Swap lexicon aliases in BOTH directions ("mars" <-> "red
    planet") so the dense encoder learns the same world-knowledge
    bridges the lexical encoder gets from canonicalization."""
    table = _alias_bidir()
    low = text.lower()
    words = low.split()
    out: List[str] = []
    i = 0
    while i < len(words):
        matched = False
        for ln in (4, 3, 2, 1):
            phrase = " ".join(words[i : i + ln]).strip(".,;:!?")
            repl = table.get(phrase)
            if repl and rng.random() < p:
                out.append(repl[rng.randrange(len(repl))])
                i += ln
                matched = True
                break
        if not matched:
            out.append(words[i])
            i += 1
    return " ".join(out)


_WH_PREFIXES = (
    "why does", "why do", "why is", "why are", "how does", "how do",
    "how is", "how can", "what makes", "what does", "what is",
    "which", "when does", "when do", "where does", "where do",
)


def make_question_pairs(
    sentences: Sequence[str],
    n_pairs: int,
    seed: int = 0,
    synonym_p: float = 0.5,
) -> Tuple[List[str], List[str]]:
    """(pseudo-question, sentence) pairs from declarative text.

    The external QA style the encoder must serve prefixes content with
    interrogative scaffolding and paraphrases the wording
    (SURVEY-level contract: one encoder for queries AND documents).
    Each pair takes a content-word crop of a sentence, substitutes
    synonyms on the query side, and prepends a wh-prefix — teaching the
    encoder that question form is noise and synonym-bridged content is
    signal."""
    rng = random.Random(seed)
    table = synonym_table()
    qs: List[str] = []
    ps: List[str] = []
    if not sentences:
        return qs, ps
    guard = 0
    while len(qs) < n_pairs and guard < n_pairs * 20:
        guard += 1
        sent = sentences[rng.randrange(len(sentences))]
        words = _WORDISH.findall(sent.lower())
        if len(words) < 6:
            continue
        # crop the middle content, drop leading stopword-ish tokens
        crop_words = _WORDISH.findall(_crop(words, rng, drop=0.15))
        if len(crop_words) < 3:
            continue
        if rng.random() < synonym_p:
            body = _substitute(crop_words, table, rng, p=0.6)
        else:
            body = " ".join(crop_words)
        q = f"{_WH_PREFIXES[rng.randrange(len(_WH_PREFIXES))]} {body}"
        qs.append(q)
        ps.append(sent.lower())
    return qs, ps


# ---------------------------------------------------------------------------
_WORDISH = re.compile(r"[A-Za-z][A-Za-z'-]*")
_STOP_HINTS = frozenset(
    "the a an of to is are was be and or for in on with this that it as by".split()
)
_CODE_CHARS = frozenset("{}[]()<>=;|\\`#@$%^&*_~/")


def looks_english(line: str, min_words: int = 5, max_words: int = 64) -> bool:
    """Heuristic natural-language filter for harvested doc lines."""
    if not line or not line.isascii():
        return False
    n_code = sum(1 for c in line if c in _CODE_CHARS)
    if n_code > max(2, len(line) * 0.03):
        return False
    words = _WORDISH.findall(line)
    if not (min_words <= len(words) <= max_words):
        return False
    alpha = sum(len(w) for w in words)
    if alpha < len(line) * 0.6:
        return False
    lower = {w.lower() for w in words}
    return len(lower & _STOP_HINTS) >= 2


def _sentences_from_text(text: str) -> Iterable[str]:
    # join wrapped lines into paragraphs, then split on sentence ends
    for para in re.split(r"\n\s*\n", text):
        joined = " ".join(ln.strip() for ln in para.splitlines())
        for sent in re.split(r"(?<=[.!?])\s+", joined):
            sent = sent.strip()
            if looks_english(sent):
                yield sent


def _iter_doc_files(roots: Sequence[str], exts=(".md", ".rst", ".txt")):
    for root in roots:
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                if f.endswith(exts):
                    yield os.path.join(dirpath, f)


def _iter_py_docstrings(roots: Sequence[str], max_files: int, rng):
    paths = []
    for root in roots:
        for dirpath, dirs, files in os.walk(root):
            dirs[:] = [d for d in dirs if d not in ("test", "tests", "__pycache__")]
            paths.extend(os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    rng.shuffle(paths)
    for p in paths[:max_files]:
        try:
            with open(p, encoding="utf-8", errors="ignore") as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError, ValueError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                doc = ast.get_docstring(node)
                if doc:
                    yield doc


def harvest_container_text(
    max_sentences: int = 300_000,
    max_py_files: int = 6_000,
    seed: int = 0,
    roots: Sequence[str] = (),
) -> List[str]:
    """English sentences from installed docs + docstrings, deduplicated."""
    rng = random.Random(seed)
    if not roots:
        import site

        roots = list(site.getsitepackages())
        stdlib = sysconfig.get_paths().get("stdlib")
        if stdlib:
            roots.append(stdlib)
    seen = set()
    out: List[str] = []

    def take(text: str) -> bool:
        for sent in _sentences_from_text(text):
            key = sent.lower()
            if key in seen:
                continue
            seen.add(key)
            out.append(sent)
            if len(out) >= max_sentences:
                return True
        return False

    for path in _iter_doc_files(roots):
        try:
            with open(path, encoding="utf-8", errors="ignore") as fh:
                if take(fh.read()):
                    return out
        except OSError:
            continue
    for doc in _iter_py_docstrings(roots, max_py_files, rng):
        if take(doc):
            return out
    return out


# ---------------------------------------------------------------------------
def _crop(words: List[str], rng: random.Random, drop: float = 0.1) -> str:
    n = len(words)
    span = max(3, int(n * rng.uniform(0.6, 0.95)))
    start = rng.randint(0, max(n - span, 0))
    kept = [w for w in words[start : start + span] if rng.random() > drop]
    return " ".join(kept) if kept else " ".join(words[start : start + span])


def _substitute(words: List[str], table: Dict[str, List[str]],
                rng: random.Random, p: float = 0.9) -> str:
    out = []
    for w in words:
        lw = w.lower()
        if lw in table and rng.random() < p:
            out.append(rng.choice(table[lw]))
        else:
            out.append(w)
    return " ".join(out)


def make_pairs(
    sentences: Sequence[str],
    n_pairs: int,
    seed: int = 0,
    synonym_frac: float = 0.5,
) -> Tuple[List[str], List[str]]:
    """(query, positive) pairs: crops of one sentence, query side
    synonym-substituted with probability ``synonym_frac``."""
    rng = random.Random(seed)
    table = synonym_table()
    qs: List[str] = []
    ps: List[str] = []
    if not sentences:
        return qs, ps
    while len(qs) < n_pairs:
        sent = sentences[rng.randrange(len(sentences))]
        words = _WORDISH.findall(sent)
        if len(words) < 5:
            continue
        q_words = _WORDISH.findall(_crop(words, rng))
        if not q_words:
            continue
        if rng.random() < synonym_frac:
            q = _substitute(q_words, table, rng)
        else:
            q = " ".join(q_words)
        p = _crop(words, rng)
        qs.append(q.lower())
        ps.append(p.lower())
    return qs, ps
