"""Transient-failure retry for device calls.

``retry_transient`` wraps a device call with bounded exponential backoff
on errors whose message marks them as transient (a lost connection, an
unavailable service); genuine program errors (shape mismatches, device
out-of-memory) re-raise immediately.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

T = TypeVar("T")

logger = logging.getLogger(__name__)

_TRANSIENT_MARKERS = (
    "remote_compile",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "Socket closed",
    "Connection reset",
    "grant",
)
_PERMANENT_MARKERS = (
    "Ran out of memory",
    "RESOURCE_EXHAUSTED",
    "INVALID_ARGUMENT",
    "CUDA out of memory",
)


def is_transient(exc: BaseException) -> bool:
    msg = str(exc)
    if any(m in msg for m in _PERMANENT_MARKERS):
        return False
    return any(m in msg for m in _TRANSIENT_MARKERS)


def retry_transient(
    fn: Callable[[], T],
    retries: int = 2,
    base_delay_s: float = 1.0,
    what: str = "device call",
) -> T:
    """Run ``fn``; retry up to ``retries`` times on transient errors."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 - filtered by is_transient
            if attempt >= retries or not is_transient(exc):
                raise
            delay = base_delay_s * (2 ** attempt)
            logger.warning(
                "%s failed transiently (%s); retry %d/%d in %.1fs",
                what, type(exc).__name__, attempt + 1, retries, delay,
            )
            time.sleep(delay)
            attempt += 1
