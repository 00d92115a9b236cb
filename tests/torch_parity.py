"""Helpers of the port's parity tests (``test_torch_*.py``): the field by
field comparison of two packages' JSON-like results, deterministic
upload ids, and a local stub of the Ollama HTTP API."""

import contextlib
import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np

# values that differ between two runs by their clocks, not by the code
TIME_KEYS = {"retrieval_time", "processing_time", "timestamp", "exported_at",
             "oldest_timestamp", "newest_timestamp", "uploaded_at",
             "avg_retrieval_time", "avg_processing_time"}
SIM_KEYS = {"similarity", "similarities"}


def assert_same_fields(j, p, path="$"):
    """Equal field for field, time-valued fields dropped, similarities
    within 1e-5."""
    if isinstance(j, dict):
        assert isinstance(p, dict), path
        jk = {k for k in j if k not in TIME_KEYS}
        assert jk == {k for k in p if k not in TIME_KEYS}, (path, jk ^ set(p))
        for k in jk:
            if k in SIM_KEYS:
                np.testing.assert_allclose(j[k], p[k], rtol=0, atol=1e-5, err_msg=path + k)
            else:
                assert_same_fields(j[k], p[k], f"{path}.{k}")
    elif isinstance(j, (list, tuple)):
        assert isinstance(p, (list, tuple)) and len(j) == len(p), path
        for i, (a, b) in enumerate(zip(j, p)):
            assert_same_fields(a, b, f"{path}[{i}]")
    else:
        assert j == p, f"{path}: {j!r} != {p!r}"


class SeqUUID:
    """Stands in for the ``uuid`` module of ``ingest/files.py``: upload
    ids from a counter, so two packages name the same uploads alike."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return SimpleNamespace(hex=f"{self.n:032x}")


def stub_embedding(prompt: str, dim: int = 384):
    seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")
    return np.random.default_rng(seed).standard_normal(dim).tolist()


@contextlib.contextmanager
def stub_ollama(dim: int = 384):
    """A local Ollama-compatible server: ``GET /api/tags``, ``POST
    /api/embeddings`` (a seeded vector per prompt) and ``POST
    /api/generate`` (a fixed answer naming the prompt's length).  Yields
    its base URL."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, payload):
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._send({"models": []})

        def do_POST(self):
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            if self.path == "/api/embeddings":
                self._send({"embedding": stub_embedding(req["prompt"], dim)})
            else:
                self._send({"response": f"An answer from {len(req['prompt'])} prompt chars."})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
