"""The three "enhancement" subsystems.

Parity with the reference (``enhanced_rag_system.py:848-1114``):

* ``CrossAppContextBridge`` (#8): links context snippets across
  applications when they share vocabulary; query-time retrieval ranks
  bridged snippets by relevance + bridge score.
* ``PredictiveContextSwitcher`` (#2): records app switches with
  time-of-day/day-of-week and predicts likely next contexts.
* ``LearningAdaptationSystem`` (#7): weighted feedback history adjusts
  confidence/verbosity/suggestion weights for similar future queries.
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple


@dataclass
class CrossAppContext:
    """Reference ``CrossAppContext`` (``enhanced_rag_system.py:622-635``)."""

    application: str
    content: str
    timestamp: float = field(default_factory=time.time)
    bridge_score: float = 0.0


_APP_PATTERN_KEYWORDS = {
    "code": ("def ", "class ", "import ", "function", "return"),
    "browser": ("http", "www", "search", ".com"),
    "terminal": ("$", "sudo", "git ", "cd ", "ls "),
    "notes": ("todo", "note", "remember", "idea"),
}


class CrossAppContextBridge:
    def __init__(self, buffer_size: int = 1000, min_shared_words: int = 3) -> None:
        self.contexts: Deque[CrossAppContext] = deque(maxlen=buffer_size)
        self.links: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.min_shared_words = min_shared_words
        self._last_app: Optional[str] = None

    # ------------------------------------------------------------------
    def _bridge_score(self, app: str, content: str) -> float:
        score = 0.0
        if self._last_app and self._last_app != app:
            score += 0.3  # app-transition bonus
        score += min(len(content) / 500.0, 0.4)  # content-length bonus
        low = content.lower()
        for words in _APP_PATTERN_KEYWORDS.values():
            if any(w in low for w in words):
                score += 0.1
                break
        return round(min(score, 1.0), 3)

    def add_context(self, application: str, content: str) -> CrossAppContext:
        ctx = CrossAppContext(
            application=application,
            content=content,
            bridge_score=self._bridge_score(application, content),
        )
        idx = len(self.contexts)
        # link to recent contexts from OTHER apps sharing >= N words
        words = set(content.lower().split())
        for j, other in enumerate(list(self.contexts)[-50:]):
            if other.application != application:
                shared = words & set(other.content.lower().split())
                if len(shared) >= self.min_shared_words:
                    key = "-".join(sorted([application, other.application]))
                    self.links[key].append((idx, j))
        self.contexts.append(ctx)
        self._last_app = application
        return ctx

    def get_bridged_context(self, query: str, top: int = 5) -> List[Dict[str, Any]]:
        qwords = set(query.lower().split())
        scored = []
        for ctx in self.contexts:
            overlap = len(qwords & set(ctx.content.lower().split()))
            if overlap:
                scored.append((overlap + ctx.bridge_score, ctx))
        scored.sort(key=lambda t: -t[0])
        return [
            {
                "application": c.application,
                "content": c.content[:200],
                "bridge_score": c.bridge_score,
                "relevance": round(s, 3),
            }
            for s, c in scored[:top]
        ]


class PredictiveContextSwitcher:
    def __init__(self, history: int = 500) -> None:
        self.switches: Deque[Dict[str, Any]] = deque(maxlen=history)
        self.patterns: Counter = Counter()

    def record_context_switch(self, from_app: str, to_app: str) -> None:
        now = time.localtime()
        self.switches.append(
            {
                "from": from_app,
                "to": to_app,
                "hour": now.tm_hour,
                "dow": now.tm_wday,
                "timestamp": time.time(),
            }
        )
        self.patterns[(from_app, to_app, now.tm_hour)] += 1

    def predict_next_context(self, current_app: str, top: int = 3) -> List[Dict[str, Any]]:
        hour = time.localtime().tm_hour
        cands: Counter = Counter()
        for (frm, to, h), n in self.patterns.items():
            if frm == current_app:
                # time-similarity weighting: same hour strongest
                w = n * (1.0 if h == hour else 0.5 if abs(h - hour) <= 2 else 0.2)
                cands[to] += w
        return [
            {"application": app, "confidence": round(min(score / 10.0, 0.9), 3)}
            for app, score in cands.most_common(top)
        ]


_FEEDBACK_WEIGHTS = {"positive": 1.2, "negative": 0.8, "ignored": 0.9, "followed": 1.3}


class LearningAdaptationSystem:
    def __init__(self, history: int = 500) -> None:
        self.feedback: Deque[Dict[str, Any]] = deque(maxlen=history)

    def record_feedback(self, query: str, feedback_type: str) -> None:
        if feedback_type not in _FEEDBACK_WEIGHTS:
            raise ValueError(
                f"feedback_type must be one of {sorted(_FEEDBACK_WEIGHTS)}"
            )
        self.feedback.append(
            {
                "query": query,
                "type": feedback_type,
                "weight": _FEEDBACK_WEIGHTS[feedback_type],
                "timestamp": time.time(),
            }
        )

    @staticmethod
    def _jaccard(a: str, b: str) -> float:
        sa, sb = set(a.lower().split()), set(b.lower().split())
        if not sa or not sb:
            return 0.0
        return len(sa & sb) / len(sa | sb)

    def get_response_adjustments(self, query: str) -> Dict[str, float]:
        """Adjustments from similar (Jaccard > 0.3) queries in last 24 h."""
        cutoff = time.time() - 86400.0
        factors = [
            f["weight"]
            for f in self.feedback
            if f["timestamp"] >= cutoff and self._jaccard(query, f["query"]) > 0.3
        ]
        if not factors:
            return {"confidence_modifier": 1.0, "verbosity": 1.0, "suggestion_weight": 1.0}
        avg = sum(factors) / len(factors)
        return {
            "confidence_modifier": round(avg, 3),
            "verbosity": round(min(max(avg, 0.7), 1.3), 3),
            "suggestion_weight": round(avg, 3),
        }
