"""Active-window tracking (X11) for the capture adapters.

Parity with the reference ``WindowTracker`` (``keystroke_logger.py:199-287``):
query the active window/app via ``xdotool`` with a ``wmctrl -l`` fallback
and an "Unknown" terminal fallback; keep a bounded window-change history.
Queries are rate-limited (the reference refreshed at most 1 Hz,
``keystroke_logger.py:408-411``).
"""

from __future__ import annotations

import shutil
import subprocess
import time
from collections import deque
from typing import Deque, Dict, Optional


class WindowTracker:
    def __init__(self, history: int = 50, min_interval_s: float = 1.0) -> None:
        self.history: Deque[Dict] = deque(maxlen=history)
        self.min_interval_s = min_interval_s
        self._last_query = 0.0
        self._last_info = {"application": "Unknown", "window_title": "Unknown"}
        self._xdotool = shutil.which("xdotool")
        self._wmctrl = shutil.which("wmctrl")

    @property
    def available(self) -> bool:
        return self._xdotool is not None or self._wmctrl is not None

    # ------------------------------------------------------------------
    def _run(self, cmd) -> Optional[str]:
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=1.0)
            return out.stdout.strip() if out.returncode == 0 else None
        except Exception:
            return None

    def _query_xdotool(self) -> Optional[Dict[str, str]]:
        if not self._xdotool:
            return None
        wid = self._run([self._xdotool, "getactivewindow"])
        if not wid:
            return None
        name = self._run([self._xdotool, "getwindowname", wid]) or "Unknown"
        cls = self._run([self._xdotool, "getwindowclassname", wid]) or "Unknown"
        return {"application": cls, "window_title": name}

    def _query_wmctrl(self) -> Optional[Dict[str, str]]:
        if not self._wmctrl:
            return None
        listing = self._run([self._wmctrl, "-l"])
        if not listing:
            return None
        # best effort: last listed window
        last = listing.splitlines()[-1].split(None, 3)
        title = last[3] if len(last) > 3 else "Unknown"
        return {"application": "Unknown", "window_title": title}

    # ------------------------------------------------------------------
    def get_active_window_info(self) -> Dict[str, str]:
        """Rate-limited active-window query with the fallback chain."""
        now = time.time()
        if now - self._last_query < self.min_interval_s:
            return self._last_info
        self._last_query = now
        info = self._query_xdotool() or self._query_wmctrl() or {
            "application": "Unknown",
            "window_title": "Unknown",
        }
        if info != self._last_info:
            self.history.append({**info, "timestamp": now})
        self._last_info = info
        return info
