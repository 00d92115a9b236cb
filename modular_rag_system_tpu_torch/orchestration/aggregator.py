"""ContextAggregator — rolling capture context for query enrichment.

Parity with the reference ``ContextAggregator``
(``rag_query_interface.py:68-221``): a rolling context buffer fed by
keystroke/OCR callbacks, per-app context lists, typing-pattern history,
recency windows, typing analysis (WPM / productivity / consistency) and
``build_query_context`` with heuristic query-type inference.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

_QUERY_TYPE_KEYWORDS = {
    "question": ("what", "why", "how", "when", "where", "who", "which", "?"),
    "suggestion": ("suggest", "recommend", "improve", "better", "should i", "advice"),
    "completion": ("complete", "finish", "continue", "next", "remaining"),
    "analysis": ("analyze", "analyse", "compare", "evaluate", "review", "summarize", "explain"),
}

RECENCY_WINDOW_S = 300.0  # reference rag_query_interface.py recency window


@dataclass
class QueryContext:
    """Reference ``QueryContext`` (``rag_query_interface.py:31-48``)."""

    current_text: str = ""
    recent_keystrokes: List[str] = field(default_factory=list)
    active_application: str = ""
    typing_speed_wpm: float = 0.0
    query_type: str = "question"
    recent_ocr: List[str] = field(default_factory=list)
    typing_analysis: Dict[str, float] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)


class ContextAggregator:
    def __init__(
        self,
        buffer_size: int = 1000,
        per_app_cap: int = 100,
        typing_cap: int = 50,
    ) -> None:
        self.context_buffer: Deque[Dict[str, Any]] = deque(maxlen=buffer_size)
        self.app_contexts: Dict[str, Deque[Dict[str, Any]]] = defaultdict(
            lambda: deque(maxlen=per_app_cap)
        )
        self.typing_patterns: Deque[Dict[str, float]] = deque(maxlen=typing_cap)

    # ------------------------------------------------------------------
    def add_keystroke_context(self, content: str, metadata: Optional[Dict] = None) -> None:
        meta = metadata or {}
        entry = {
            "kind": "keystroke",
            "content": content,
            "app": meta.get("application", "unknown"),
            "wpm": float(meta.get("wpm", 0.0)),
            "timestamp": meta.get("timestamp", time.time()),
        }
        self.context_buffer.append(entry)
        self.app_contexts[entry["app"]].append(entry)
        if entry["wpm"] > 0:
            self.typing_patterns.append(
                {"wpm": entry["wpm"], "timestamp": entry["timestamp"]}
            )

    def add_ocr_context(self, content: str, metadata: Optional[Dict] = None) -> None:
        meta = metadata or {}
        self.context_buffer.append(
            {
                "kind": "ocr",
                "content": content,
                "app": meta.get("application", "unknown"),
                "confidence": float(meta.get("confidence", 0.0)),
                "timestamp": meta.get("timestamp", time.time()),
            }
        )

    # ------------------------------------------------------------------
    def recent(self, kind: Optional[str] = None, window_s: float = RECENCY_WINDOW_S) -> List[Dict]:
        cutoff = time.time() - window_s
        return [
            e
            for e in self.context_buffer
            if e["timestamp"] >= cutoff and (kind is None or e["kind"] == kind)
        ]

    def get_recent_context(self, window_s: float = RECENCY_WINDOW_S) -> List[Dict]:
        """All recent context entries (reference-name convenience)."""
        return self.recent(None, window_s)

    def get_application_context(self, app: str) -> List[Dict[str, Any]]:
        """Context entries for one application (reference-name parity)."""
        return list(self.app_contexts.get(app, []))

    def get_typing_analysis(self) -> Dict[str, float]:
        """avg WPM; productivity = wpm/50 capped at 1; consistency = 1 - σ/μ

        (reference ``rag_query_interface.py:~140-170``)."""
        if not self.typing_patterns:
            return {"avg_wpm": 0.0, "productivity": 0.0, "consistency": 0.0}
        wpms = [p["wpm"] for p in self.typing_patterns]
        n = len(wpms)
        mean = sum(wpms) / n
        var = sum((w - mean) ** 2 for w in wpms) / n
        std = var ** 0.5
        return {
            "avg_wpm": mean,
            "productivity": min(mean / 50.0, 1.0),
            "consistency": max(0.0, 1.0 - (std / mean if mean > 0 else 1.0)),
        }

    # ------------------------------------------------------------------
    @staticmethod
    def infer_query_type(query: str) -> str:
        low = query.lower()
        best, hits = "question", 0
        for qtype, words in _QUERY_TYPE_KEYWORDS.items():
            n = sum(1 for w in words if w in low)
            if n > hits:
                best, hits = qtype, n
        return best if hits else "question"

    def build_query_context(self, query: str) -> QueryContext:
        recent_ks = self.recent("keystroke")
        recent_ocr = self.recent("ocr")
        active_app = recent_ks[-1]["app"] if recent_ks else (
            recent_ocr[-1]["app"] if recent_ocr else ""
        )
        analysis = self.get_typing_analysis()
        return QueryContext(
            current_text=query,
            recent_keystrokes=[e["content"] for e in recent_ks[-10:]],
            active_application=active_app,
            typing_speed_wpm=analysis["avg_wpm"],
            query_type=self.infer_query_type(query),
            recent_ocr=[e["content"] for e in recent_ocr[-5:]],
            typing_analysis=analysis,
        )
