"""OCR ingest adapter (optional).

Parity with the reference OCR loop (``run_integrated_rag.py:251-296``):
a background thread polls a pluggable OCR backend every
``analysis_interval`` seconds; results with confidence >=
``min_confidence`` are passed (through the privacy filter) to the sink
callback as ``content_type='ocr'``.

The reference's backend (``OCRAssistant`` from ``../Screenshare``) was
external to the repo; here the backend is any callable returning
``{"text": str, "confidence": float, "window": str}`` — a stub backend is
provided for tests, and screen-capture backends can be plugged in where
available.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from modular_rag_system_tpu_torch.ingest.privacy import PrivacyFilter

OCRResult = Dict[str, Any]
OCRBackend = Callable[[], Optional[OCRResult]]


class OCRIngestLoop:
    def __init__(
        self,
        backend: OCRBackend,
        sink: Callable[[str, Dict[str, Any]], None],
        privacy: Optional[PrivacyFilter] = None,
        analysis_interval_s: float = 10.0,
        min_confidence: float = 0.7,
    ) -> None:
        self.backend = backend
        self.sink = sink
        self.privacy = privacy or PrivacyFilter()
        self.interval = analysis_interval_s
        self.min_confidence = min_confidence
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats = {"polls": 0, "accepted": 0, "low_confidence": 0, "filtered": 0}

    # ------------------------------------------------------------------
    def poll_once(self) -> bool:
        """One poll cycle (also the test entry point). True if ingested."""
        self.stats["polls"] += 1
        result = self.backend()
        if not result or not result.get("text"):
            return False
        if float(result.get("confidence", 0.0)) < self.min_confidence:
            self.stats["low_confidence"] += 1
            return False
        window = result.get("window", "")
        if self.privacy.should_block_application(window, window):
            self.stats["filtered"] += 1
            return False
        text = result["text"]
        if self.privacy.is_sensitive_content(text):
            self.stats["filtered"] += 1
            return False
        self.sink(
            self.privacy.anonymize_text(text),
            {
                "content_type": "ocr",
                "confidence": float(result.get("confidence", 0.0)),
                "application": window or "screen",
                "timestamp": time.time(),
            },
        )
        self.stats["accepted"] += 1
        return True

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.poll_once()
                except Exception:
                    pass  # backend hiccups never kill the loop

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def stub_backend(text: str = "", confidence: float = 0.9) -> OCRBackend:
    """Deterministic backend for tests/demo."""

    def backend() -> Optional[OCRResult]:
        return {"text": text, "confidence": confidence, "window": "stub"} if text else None

    return backend
