"""Keystroke capture adapter (optional, consent-based self-logging).

Reimplements the semantics of the reference ``KeystrokeLogger``
(``keystroke_logger.py:290-702``) as ONE optional ingest adapter behind
the privacy filter:

* event queue -> daemon consumer thread, bounded (drop + count when full),
* session management: new session after 300 s idle or app change,
* buffer flush every 100 events or on idle timeout,
* backspace-aware text reconstruction (``keystroke_logger.py:603-623``),
* sensitive sessions dropped entirely; others anonymized,
* WPM computation; ``rag_callback(content, metadata)`` fired for content
  >= ``min_content_len`` chars,
* JSON session export + statistics.

The OS listener (pynput) is optional: ``attach_listener()`` activates it
when the library and a display are present; ``feed_event`` is the
headless/test entry point (and what the listener calls internally).
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from modular_rag_system_tpu_torch.ingest.privacy import PrivacyFilter

SESSION_TIMEOUT_S = 300.0
FLUSH_EVERY_EVENTS = 100
MIN_CONTENT_LEN = 10


@dataclass
class KeystrokeEvent:
    """Reference ``KeystrokeEvent`` (``keystroke_logger.py:39-55``)."""

    key: str
    pressed: bool
    timestamp: float
    application: str = "unknown"
    window_title: str = ""
    session_id: str = ""
    filtered: bool = False


@dataclass
class TypingSession:
    """Reference ``TypingSession`` (``keystroke_logger.py:57-73``)."""

    session_id: str
    application: str
    started_at: float
    ended_at: float = 0.0
    event_count: int = 0
    wpm: float = 0.0
    content: str = ""
    content_hash: str = ""
    filtered: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        if self.filtered:
            d["content"] = ""  # never export filtered content
        return d


class KeystrokeCapture:
    def __init__(
        self,
        privacy: Optional[PrivacyFilter] = None,
        rag_callback: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        session_timeout_s: float = SESSION_TIMEOUT_S,
        queue_size: int = 1000,
    ) -> None:
        self.privacy = privacy or PrivacyFilter()
        self.rag_callback = rag_callback
        self.session_timeout_s = session_timeout_s
        self._queue: "queue.Queue[KeystrokeEvent]" = queue.Queue(maxsize=queue_size)
        self._buffer: List[KeystrokeEvent] = []
        self._sessions: List[TypingSession] = []
        self._consumer: Optional[threading.Thread] = None
        self._running = False
        self._listener = None
        self._cur_session: Optional[str] = None
        self._cur_app: Optional[str] = None
        self._last_event_ts = 0.0
        self.stats = {
            "events_total": 0,
            "events_dropped": 0,
            "sessions_total": 0,
            "sessions_filtered": 0,
            "callbacks_fired": 0,
        }
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def set_rag_callback(self, cb: Callable[[str, Dict[str, Any]], None]) -> None:
        self.rag_callback = cb

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._consumer = threading.Thread(target=self._consume_loop, daemon=True)
        self._consumer.start()

    def stop(self) -> None:
        self._running = False
        self.detach_listener()
        if self._consumer:
            self._consumer.join(timeout=2.0)
            self._consumer = None
        self._flush(force=True)

    # ------------------------------------------------------------------
    def feed_event(
        self,
        key: str,
        pressed: bool = True,
        application: str = "unknown",
        window_title: str = "",
        timestamp: Optional[float] = None,
    ) -> bool:
        """Headless event entry point. Returns False if dropped."""
        if self.privacy.should_block_application(application, window_title):
            return False
        ev = KeystrokeEvent(
            key=key,
            pressed=pressed,
            timestamp=timestamp if timestamp is not None else time.time(),
            application=application,
            window_title=window_title,
        )
        try:
            self._queue.put_nowait(ev)
            return True
        except queue.Full:
            self.stats["events_dropped"] += 1
            return False

    # ------------------------------------------------------------------
    def _consume_loop(self) -> None:
        while self._running:
            try:
                ev = self._queue.get(timeout=1.0)
            except queue.Empty:
                # close out the buffered session only after the REAL
                # session timeout — flushing on every 1 s queue idle
                # fragmented normal typing pauses into micro-sessions
                with self._lock:
                    idle = time.time() - self._last_event_ts
                    if self._buffer and idle > self.session_timeout_s:
                        self._flush(force=True)
                continue
            self._handle_event(ev)

    def drain(self) -> None:
        """Synchronously process queued events (test/headless helper)."""
        while True:
            try:
                ev = self._queue.get_nowait()
            except queue.Empty:
                break
            self._handle_event(ev)
        self._flush(force=True)

    def _handle_event(self, ev: KeystrokeEvent) -> None:
        with self._lock:
            if not ev.pressed:
                return
            # session management: timeout or app change -> new session
            if (
                self._cur_session is None
                or ev.application != self._cur_app
                or ev.timestamp - self._last_event_ts > self.session_timeout_s
            ):
                self._flush(force=True)
                sid = hashlib.md5(
                    f"{ev.application}|{ev.timestamp}".encode()
                ).hexdigest()[:12]
                self._cur_session = sid
                self._cur_app = ev.application
            ev.session_id = self._cur_session
            self._last_event_ts = ev.timestamp
            self._buffer.append(ev)
            self.stats["events_total"] += 1
            if len(self._buffer) >= FLUSH_EVERY_EVENTS:
                self._flush()

    # ------------------------------------------------------------------
    @staticmethod
    def _reconstruct_text(events: List[KeystrokeEvent]) -> str:
        """Backspace-aware reconstruction (``keystroke_logger.py:603-623``)."""
        out: List[str] = []
        for ev in events:
            k = ev.key
            if k in ("backspace", "\b"):
                if out:
                    out.pop()
            elif k in ("space",):
                out.append(" ")
            elif k in ("enter", "\n"):
                out.append("\n")
            elif len(k) == 1:
                out.append(k)
            # other special keys (shift, ctrl, arrows...) are ignored
        return "".join(out)

    def _flush(self, force: bool = False) -> None:
        with self._lock:
            if not self._buffer:
                return
            if not force and len(self._buffer) < FLUSH_EVERY_EVENTS:
                return
            events, self._buffer = self._buffer, []
            by_session: Dict[str, List[KeystrokeEvent]] = {}
            for ev in events:
                by_session.setdefault(ev.session_id, []).append(ev)
            for sid, evs in by_session.items():
                self._finish_session(sid, evs)

    def _finish_session(self, sid: str, events: List[KeystrokeEvent]) -> None:
        text = self._reconstruct_text(events)
        t0, t1 = events[0].timestamp, events[-1].timestamp
        dur_min = max((t1 - t0) / 60.0, 1e-6)
        wpm = (len(text.split()) / dur_min) if text else 0.0
        session = TypingSession(
            session_id=sid,
            application=events[0].application,
            started_at=t0,
            ended_at=t1,
            event_count=len(events),
            wpm=round(wpm, 1),
        )
        self.stats["sessions_total"] += 1
        if self.privacy.is_sensitive_content(text):
            # sensitive sessions dropped entirely (keystroke_logger.py:554-556)
            session.filtered = True
            self.stats["sessions_filtered"] += 1
            self._sessions.append(session)
            return
        text = self.privacy.anonymize_text(text)
        session.content = text
        session.content_hash = hashlib.md5(text.encode()).hexdigest()
        self._sessions.append(session)
        if self.rag_callback and len(text) >= MIN_CONTENT_LEN:
            self.stats["callbacks_fired"] += 1
            self.rag_callback(
                text,
                {
                    "application": session.application,
                    "session_id": sid,
                    "wpm": session.wpm,
                    "timestamp": t1,
                    "content_type": "keystroke",
                },
            )

    # ------------------------------------------------------------------
    def export_sessions(self, path: str) -> str:
        with self._lock:
            payload = {
                "exported_at": time.time(),
                "sessions": [s.to_dict() for s in self._sessions],
                "stats": dict(self.stats),
            }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return path

    def get_statistics(self) -> Dict[str, Any]:
        with self._lock:
            wpms = [s.wpm for s in self._sessions if s.wpm > 0]
            return {
                **self.stats,
                "avg_wpm": round(sum(wpms) / len(wpms), 1) if wpms else 0.0,
                "queue_depth": self._queue.qsize(),
            }

    # ------------------------------------------------------------------
    # optional OS listener (pynput); headless environments skip this
    def attach_listener(self) -> bool:
        try:
            from pynput import keyboard  # type: ignore
        except Exception:
            return False

        def on_press(key):
            name = getattr(key, "char", None) or getattr(key, "name", str(key))
            self.feed_event(name, pressed=True)

        self._listener = keyboard.Listener(on_press=on_press)
        self._listener.daemon = True
        self._listener.start()
        return True

    def detach_listener(self) -> None:
        if self._listener is not None:
            self._listener.stop()
            self._listener = None


def _main(argv=None) -> int:
    """Module CLI (reference ``keystroke_logger.py:709-725`` parity):

    ``python -m modular_rag_system_tpu_torch.ingest.keystrokes --test | --stats
    | --export sessions.json``.  ``--test`` runs a synthetic session
    through the full privacy + reconstruction pipeline."""
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(prog="keystrokes")
    ap.add_argument("--test", action="store_true", help="synthetic smoke test")
    ap.add_argument("--stats", action="store_true", help="print statistics")
    ap.add_argument("--export", default=None, help="export sessions to JSON")
    ap.add_argument("--listen", action="store_true",
                    help="attach the OS listener (requires pynput + display)")
    args = ap.parse_args(argv)
    captured = []
    kc = KeystrokeCapture(rag_callback=lambda c, m: captured.append((c, m)))
    if args.test:
        for ch in "the quick brown fox typed this sentence":
            kc.feed_event(ch if ch != " " else "space", application="test-app")
        for ch in "password: hunter2":  # must be dropped
            kc.feed_event(ch if ch != " " else "space", application="secrets-app")
        kc.drain()
        ok = (len(captured) == 1
              and captured[0][0] == "the quick brown fox typed this sentence"
              and kc.stats["sessions_filtered"] == 1)
        print(f"reconstructed: {captured[0][0]!r}" if captured else "no capture")
        print(f"sensitive sessions dropped: {kc.stats['sessions_filtered']}")
        print("self-test:", "PASSED" if ok else "FAILED")
        return 0 if ok else 1
    if args.listen:
        kc.start()
        if not kc.attach_listener():
            print("pynput/display unavailable; cannot listen")
            return 1
        print("listening; Ctrl-C to stop")
        try:
            import time as _t

            while True:
                _t.sleep(1)
        except KeyboardInterrupt:
            kc.stop()
    if args.export:
        print("exported:", kc.export_sessions(args.export))
    if args.stats:
        print(_json.dumps(kc.get_statistics(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
