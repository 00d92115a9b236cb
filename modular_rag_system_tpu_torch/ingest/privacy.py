"""Privacy filter for capture adapters.

Reimplements the semantics of the reference ``PrivacyFilter``
(``keystroke_logger.py:76-196``): application/window blocklists by
substring, sensitive-content regexes (card numbers, SSNs, emails, phones,
API-key assignments, password indicators), anonymization via
``[REDACTED_i]`` replacement, and a retroactive sequence filter that
marks recent keystrokes once accumulated text turns sensitive.

All capture adapters (keystrokes, OCR) pass their text through this
filter BEFORE anything reaches the embedding pipeline or document store.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

_SENSITIVE_PATTERNS: Dict[str, re.Pattern] = {
    "credit_card": re.compile(r"\b(?:\d[ -]?){13,19}\b"),
    "ssn": re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),
    "email": re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.]+\b"),
    "phone": re.compile(r"\b(?:\+?\d{1,3}[ -]?)?(?:\(\d{2,4}\)[ -]?)?\d{3}[ -]?\d{3,4}[ -]?\d{0,4}\b"),
    "passport": re.compile(r"\b[A-Z]{1,2}\d{6,9}\b"),
    "api_key": re.compile(
        r"(?i)\b(?:api[_-]?key|secret|token|password|passwd|pwd)\s*[:=]\s*\S+"
    ),
}

_PASSWORD_WORDS = ("password", "passphrase", "secret", "pin code", "otp")


class PrivacyFilter:
    def __init__(
        self,
        enabled: bool = True,
        anonymize: bool = True,
        blocked_applications: Sequence[str] = (),
        blocked_window_keywords: Sequence[str] = (),
    ) -> None:
        self.enabled = enabled
        self.anonymize_enabled = anonymize
        self.blocked_applications = [a.lower() for a in blocked_applications]
        self.blocked_window_keywords = [w.lower() for w in blocked_window_keywords]

    # ------------------------------------------------------------------
    def should_block_application(self, app_name: str, window_title: str = "") -> bool:
        if not self.enabled:
            return False
        app = (app_name or "").lower()
        title = (window_title or "").lower()
        if any(b in app for b in self.blocked_applications):
            return True
        if any(w in title for w in self.blocked_window_keywords):
            return True
        return False

    # ------------------------------------------------------------------
    def is_sensitive_content(self, text: str) -> bool:
        if not self.enabled or not text:
            return False
        low = text.lower()
        if any(w in low for w in _PASSWORD_WORDS):
            return True
        for name, pat in _SENSITIVE_PATTERNS.items():
            if name == "phone":
                # phones false-positive heavily; require >= 7 digits
                for m in pat.finditer(text):
                    if sum(ch.isdigit() for ch in m.group()) >= 7:
                        return True
                continue
            if pat.search(text):
                return True
        return False

    def sensitive_kinds(self, text: str) -> List[str]:
        return [n for n, p in _SENSITIVE_PATTERNS.items() if p.search(text or "")]

    # ------------------------------------------------------------------
    def anonymize_text(self, text: str) -> str:
        """Replace each sensitive match with ``[REDACTED_i]``."""
        if not self.enabled or not self.anonymize_enabled or not text:
            return text
        i = 0

        def repl(_m):
            nonlocal i
            i += 1
            return f"[REDACTED_{i}]"

        out = text
        for name, pat in _SENSITIVE_PATTERNS.items():
            if name == "phone":
                # same >=7-digit guard as is_sensitive_content: short
                # numbers (order ids, dates) must not be redacted
                out = pat.sub(
                    lambda m: repl(m)
                    if sum(ch.isdigit() for ch in m.group()) >= 7
                    else m.group(),
                    out,
                )
            else:
                out = pat.sub(repl, out)
        return out

    # ------------------------------------------------------------------
    def filter_keystroke_sequence(
        self, events: List[dict], window: int = 10
    ) -> Tuple[List[dict], bool]:
        """If the accumulated text is sensitive, retroactively mark the

        last ``window`` events filtered (reference behavior)."""
        text = "".join(e.get("key", "") for e in events if len(e.get("key", "")) == 1)
        if self.is_sensitive_content(text):
            for e in events[-window:]:
                e["filtered"] = True
            return events, True
        return events, False
