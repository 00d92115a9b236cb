"""Native text engine: ``text_engine.cpp`` built with g++ and loaded with ctypes.

``get_engine()`` returns the loaded ``TextEngine``, or None when g++ is
missing or the build or load fails; the tokenizers then take their
pure-Python path, whose ids are the same.  A failed build is logged once,
with the compiler's output.

The engine takes any text that encodes to UTF-8: the wrappers lowercase
it in Python (``str.lower``, Unicode's own rules) and hand the engine its
UTF-8 bytes, which it scans code point by code point.  A text holding a
lone surrogate cannot be encoded; the tokenizers keep such a row on
their Python path.

At first use the source is compiled (``g++ -O3 -shared -fPIC -std=c++17``)
into ``_build/libtextengine-<hash>.so``, named by the hash of the source,
so an edited source rebuilds.  The compiler writes to a name of its own
process and the result is renamed into place, so processes that build at
the same time (test workers) never load a half-written library.  Build by
hand, or rebuild after deleting ``_build/``:

    g++ -O3 -shared -fPIC -std=c++17 -o _build/libtextengine-<hash>.so text_engine.cpp

Every entry point of the library only reads its inputs, and ctypes
releases the interpreter lock around each call, so the tokenizers may be
called from several threads at once (the query batcher's flush workers).
A ``WpHandle`` owns its native WordPiece table and frees it when it is
collected; a call in flight holds a reference to the handle.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "text_engine.cpp"
BUILD_DIR = NATIVE_DIR / "_build"
_ABI = 3

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_engine: Optional["TextEngine"] = None
_tried = False


def library_path() -> Path:
    """The shared library's path for the current source."""
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libtextengine-{digest}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns the library's
    path.  Raises ``RuntimeError`` (with the compiler's output) when g++
    is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native text engine cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}-{threading.get_ident()}.so")
    proc = subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE),
                           "-o", str(tmp)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {proc.returncode} building {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_INT = ctypes.c_int


def _pack(texts: Sequence[str]) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """Lowercased texts as one UTF-8 blob with (offset, length) in bytes
    per text."""
    lowered: List[bytes] = [t.lower().encode("utf-8") for t in texts]
    lengths = np.array([len(b) for b in lowered], dtype=np.int64)
    offsets = np.zeros(len(lowered), dtype=np.int64)
    if len(lowered) > 1:
        offsets[1:] = np.cumsum(lengths)[:-1]
    return b"".join(lowered), offsets, lengths


class TextEngine:
    """The loaded library, with every entry point's C signature declared."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        lib.te_tokenize_batch.argtypes = [ctypes.c_char_p, _I64, _I64, _INT, _INT, _INT,
                                          _INT, _I32, _I32]
        lib.te_tokenize_batch.restype = None
        lib.te_token_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, _INT]
        lib.te_token_count.restype = ctypes.c_int64
        lib.te_wp_create.argtypes = [ctypes.c_char_p, _I64, _I64, _INT, _INT, _INT, _INT,
                                     _INT]
        lib.te_wp_create.restype = ctypes.c_void_p
        lib.te_wp_set_ids.argtypes = [ctypes.c_void_p, _I32, _INT]
        lib.te_wp_set_ids.restype = None
        lib.te_wp_destroy.argtypes = [ctypes.c_void_p]
        lib.te_wp_destroy.restype = None
        lib.te_wp_tokenize_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _I64, _I64,
                                             _INT, _INT, _I32, _I32]
        lib.te_wp_tokenize_batch.restype = None
        lib.te_wp_token_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.te_wp_token_count.restype = ctypes.c_int64

    def tokenize_batch(self, texts: Sequence[str], max_len: int, vocab_size: int,
                       piece_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """``HashingTokenizer.encode_batch`` of ``texts``."""
        blob, offsets, lengths = _pack(texts)
        ids = np.zeros((len(texts), max_len), dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=np.int32)
        self._lib.te_tokenize_batch(blob, offsets, lengths, len(texts), max_len,
                                    vocab_size, piece_len, ids, mask)
        return ids, mask

    def token_count(self, text: str, piece_len: int) -> int:
        b = text.lower().encode("utf-8")
        return int(self._lib.te_token_count(b, len(b), piece_len))

    def wp_create(self, pieces: Sequence[bytes], ids: np.ndarray, unk: int, cls: int,
                  sep: int, pad: int) -> "WpHandle":
        """A native WordPiece table of ``pieces`` (UTF-8) with their ``ids``."""
        blob = b"".join(pieces)
        lens = np.array([len(p) for p in pieces], dtype=np.int64)
        offs = np.zeros(len(pieces), dtype=np.int64)
        if len(pieces) > 1:
            offs[1:] = np.cumsum(lens)[:-1]
        h = self._lib.te_wp_create(blob, offs, lens, len(pieces), unk, cls, sep, pad)
        self._lib.te_wp_set_ids(h, np.ascontiguousarray(ids, np.int32), len(pieces))
        return WpHandle(self, h)


class WpHandle:
    """An owned native WordPiece table, freed when the handle is collected."""

    def __init__(self, engine: TextEngine, handle: int) -> None:
        self._lib = engine._lib
        self._h = handle

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.te_wp_destroy(self._h)
            self._h = None

    def tokenize_batch(self, texts: Sequence[str], max_len: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """``WordPieceTokenizer.encode_batch`` of ``texts``."""
        blob, offsets, lengths = _pack(texts)
        ids = np.zeros((len(texts), max_len), dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=np.int32)
        self._lib.te_wp_tokenize_batch(self._h, blob, offsets, lengths, len(texts),
                                       max_len, ids, mask)
        return ids, mask

    def token_count(self, text: str) -> int:
        b = text.lower().encode("utf-8")
        return int(self._lib.te_wp_token_count(self._h, b, len(b)))


def get_engine() -> Optional[TextEngine]:
    """The process's ``TextEngine``, built and loaded at the first call;
    None (the failure logged once) when it cannot be built or loaded."""
    global _engine, _tried
    with _lock:
        if _engine is not None or _tried:
            return _engine
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            if lib.te_abi_version() != _ABI:
                raise RuntimeError(f"ABI {lib.te_abi_version()} != {_ABI}")
            _engine = TextEngine(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            logger.warning("native text engine unavailable, the tokenizers take their "
                           "Python path: %s", exc)
        return _engine
