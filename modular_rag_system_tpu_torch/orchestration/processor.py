"""RAGQueryProcessor — the 5-step query pipeline with caching, confidence

scoring, synthesis and follow-ups.

Parity with the reference ``RAGQueryProcessor``
(``rag_query_interface.py:224-571``):

1. retrieval with query-type-tuned parameters (question -> k=7;
   completion -> k=3 + ``source_filters=['keystroke']``; the active app
   name is appended to the query text, ``:287-311``),
2. enhanced-context build,
3. optional LLM analysis (Ollama / llama3-cli handoff; skipped cleanly
   when no LLM is reachable),
4. markdown synthesis (``:359-388``),
5. confidence score: 0.4 * ai + 0.3 * avg-similarity + 0.2 * doc-count
   factor + query-type bonus (``:390-412``); canned follow-ups per type
   (``:414-448``).

Response cache: md5 key in 5-minute time buckets, 300 s expiry, capacity
100 evicted to 50 (``:508-546``).  Any internal failure returns a
fallback response instead of raising (``:548-571``).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from modular_rag_system_tpu_torch.orchestration.aggregator import QueryContext
from modular_rag_system_tpu_torch.types import RetrievalResult

_TYPE_PARAMS = {
    # query type -> (max_results, source_filters)
    "question": (7, None),
    "suggestion": (5, None),
    "completion": (3, ["keystroke"]),
    "analysis": (8, None),
}

_TYPE_BONUS = {"question": 0.05, "analysis": 0.05, "suggestion": 0.0, "completion": 0.0}

_FOLLOW_UPS = {
    "question": [
        "Can you give more detail on {topic}?",
        "What related documents mention {topic}?",
        "When was {topic} last discussed?",
    ],
    "suggestion": [
        "What alternatives exist for {topic}?",
        "What are the trade-offs of {topic}?",
    ],
    "completion": [
        "Continue from the last paragraph about {topic}.",
        "What usually follows {topic} in my notes?",
    ],
    "analysis": [
        "Compare {topic} with earlier entries.",
        "Summarize the history of {topic}.",
    ],
}


@dataclass
class EnhancedResponse:
    """Reference ``EnhancedResponse`` (``rag_query_interface.py:50-66``)."""

    query: str
    insight: str
    rag_result: Optional[RetrievalResult]
    confidence: float
    follow_up_queries: List[str]
    sources: List[Dict[str, Any]]
    query_type: str
    processing_time: float
    from_cache: bool = False
    ai_analysis: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)


class RAGQueryProcessor:
    def __init__(
        self,
        engine,
        llm_client=None,
        cache_ttl_s: float = 300.0,
        cache_max: int = 100,
    ) -> None:
        self.engine = engine
        self.llm = llm_client
        self.cache_ttl_s = cache_ttl_s
        self.cache_max = cache_max
        self._cache: Dict[str, EnhancedResponse] = {}
        self.stats = {"queries": 0, "cache_hits": 0, "llm_calls": 0, "fallbacks": 0}

    # ------------------------------------------------------------------
    def _cache_key(self, query: str, qtype: str) -> str:
        bucket = int(time.time() // self.cache_ttl_s)  # 5-min buckets
        return hashlib.md5(f"{query}|{qtype}|{bucket}".encode()).hexdigest()

    def _cache_put(self, key: str, resp: EnhancedResponse) -> None:
        self._cache[key] = resp
        if len(self._cache) > self.cache_max:
            # evict oldest half (reference cap 100 -> 50)
            for k in list(self._cache)[: len(self._cache) - self.cache_max // 2]:
                del self._cache[k]

    # ------------------------------------------------------------------
    def process_query(
        self, query: str, context: Optional[QueryContext] = None
    ) -> EnhancedResponse:
        t0 = time.perf_counter()
        self.stats["queries"] += 1
        ctx = context or QueryContext(current_text=query)
        qtype = ctx.query_type or "question"
        key = self._cache_key(query, qtype)
        cached = self._cache.get(key)
        if cached is not None:
            self.stats["cache_hits"] += 1
            return EnhancedResponse(**{**cached.__dict__, "from_cache": True})
        try:
            resp = self._process(query, ctx, qtype)
        except Exception as exc:  # fallback response, never raise
            self.stats["fallbacks"] += 1
            resp = EnhancedResponse(
                query=query,
                insight=(
                    "I couldn't retrieve supporting context for this query. "
                    f"({type(exc).__name__})"
                ),
                rag_result=None,
                confidence=0.1,
                follow_up_queries=[],
                sources=[],
                query_type=qtype,
                processing_time=time.perf_counter() - t0,
                metadata={"fallback": True, "error": str(exc)},
            )
            return resp
        resp.processing_time = time.perf_counter() - t0
        self._cache_put(key, resp)
        return resp

    # ------------------------------------------------------------------
    def _process(self, query: str, ctx: QueryContext, qtype: str) -> EnhancedResponse:
        # 1. type-tuned retrieval; active app appended to the query text
        k, source_filters = _TYPE_PARAMS.get(qtype, (5, None))
        search_text = query
        if ctx.active_application:
            search_text = f"{query} {ctx.active_application}"
        rag = self.engine.query(
            search_text,
            context={"query_type": qtype},
            max_results=k,
            source_filters=source_filters,
        )
        # 2. enhanced context
        enhanced = self.engine.get_enhanced_context(query) if rag.documents else None
        # 3. optional LLM analysis
        ai_text = None
        if self.llm is not None and getattr(self.llm, "available", False):
            prompt = self._build_prompt(query, rag, ctx)
            ai_text = self.llm.generate(prompt)
            if ai_text:
                self.stats["llm_calls"] += 1
        # 4. synthesis
        insight = self._synthesize(query, qtype, rag, enhanced, ai_text)
        # 5. confidence + follow-ups
        confidence = self._confidence(qtype, rag, ai_text)
        follow_ups = self._follow_ups(query, qtype, rag)
        sources = [
            {
                "id": d.id,
                "source": d.source,
                "content_type": d.content_type,
                "similarity": s,
                "snippet": d.content[:200],
            }
            for d, s in zip(rag.documents, rag.similarities)
        ]
        return EnhancedResponse(
            query=query,
            insight=insight,
            rag_result=rag,
            confidence=confidence,
            follow_up_queries=follow_ups,
            sources=sources,
            query_type=qtype,
            processing_time=0.0,
            ai_analysis=ai_text,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _build_prompt(query: str, rag: RetrievalResult, ctx: QueryContext) -> str:
        snippets = "\n".join(
            f"- [{d.source}] {d.content[:300]}" for d in rag.documents[:5]
        )
        app = f"\nActive application: {ctx.active_application}" if ctx.active_application else ""
        return (
            "You are a personal knowledge assistant. Using ONLY the context "
            f"below, answer the question.{app}\n\nContext:\n{snippets}\n\n"
            f"Question: {query}\nAnswer:"
        )

    @staticmethod
    def _synthesize(query, qtype, rag, enhanced, ai_text) -> str:
        """Markdown synthesis (reference ``rag_query_interface.py:359-388``)."""
        lines = [f"## Insight for: {query}", ""]
        if ai_text:
            lines += ["### Analysis", ai_text.strip(), ""]
        if rag.documents:
            lines.append("### Retrieved context")
            for d, s in zip(rag.documents[:5], rag.similarities[:5]):
                lines.append(f"- ({s:.2f}) [{d.source}] {d.content[:160]}")
            lines.append("")
        if enhanced and enhanced.get("themes"):
            lines.append("### Themes")
            lines.append(", ".join(enhanced["themes"][:8]))
            lines.append("")
        if not rag.documents and not ai_text:
            lines.append("_No relevant context found._")
        return "\n".join(lines).strip()

    @staticmethod
    def _confidence(qtype, rag, ai_text) -> float:
        """0.4 ai + 0.3 avg-sim + 0.2 doc-count + type bonus

        (reference ``rag_query_interface.py:390-412``)."""
        ai_part = 0.4 if ai_text else 0.0
        avg_sim = (
            sum(rag.similarities) / len(rag.similarities) if rag.similarities else 0.0
        )
        doc_part = 0.2 * min(len(rag.documents) / 5.0, 1.0)
        score = ai_part + 0.3 * avg_sim + doc_part + _TYPE_BONUS.get(qtype, 0.0)
        return round(min(score, 1.0), 3)

    @staticmethod
    def _follow_ups(query: str, qtype: str, rag: Optional[RetrievalResult] = None) -> List[str]:
        words = [w for w in query.split() if len(w) > 3]
        topic = " ".join(words[:3]) if words else query
        ups = [t.format(topic=topic) for t in _FOLLOW_UPS.get(qtype, [])]
        # recency-aware follow-up (reference rag_query_interface.py:~440:
        # most-recent hit < 24 h / < 1 week steers the suggestion)
        if rag is not None and rag.documents:
            newest = max(d.timestamp for d in rag.documents)
            age_h = (time.time() - newest) / 3600.0
            if age_h < 24:
                ups.append("What has changed since I last worked on this today?")
            elif age_h < 168:
                ups.append("How has my approach evolved this week?")
        return ups[:4]

    # ------------------------------------------------------------------
    def get_stats(self) -> Dict[str, Any]:
        return {**self.stats, "cache_size": len(self._cache)}
