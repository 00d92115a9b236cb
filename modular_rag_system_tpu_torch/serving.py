"""HTTP serving API for the full system.

The reference's only HTTP surface was the file server
(``GET /files``, ``enhanced_rag_system.py:662-745``).  A production
retrieval service also needs a query path, so the daemon exposes a small
JSON API over the same ThreadingHTTPServer pattern:

    GET  /health            -> {"status": "ok", ...}
    GET  /stats             -> get_system_stats()
    POST /query             {"query": str, "max_results"?, "enhanced"?}
    POST /add               {"content": str, "source"?, "content_type"?}
    POST /feedback          {"query": str, "type": "positive"|...}
    GET  /files             (delegated to the file manager's listing)

CORS matches the reference's permissive ``*``.  The server is a daemon
thread.  Non-enhanced ``POST /query`` requests flow through a
``QueryBatcher`` (``batching.py``): concurrent single queries coalesce
into one device dispatch, so HTTP throughput rides the kernel's
batch-scaling curve instead of paying one corpus scan per request.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class RAGHTTPServer:
    def __init__(self, system, host: str = "127.0.0.1", port: int = 8090) -> None:
        self.system = system
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.batcher = None

    # ------------------------------------------------------------------
    def start(self) -> int:
        if self._server is not None:
            return self.port
        system = self.system
        # the batcher's collector thread + flush pool live exactly as
        # long as the server: created here (not __init__, which may never
        # be followed by start) and re-created on restart after stop()
        scfg = getattr(system.engine.config, "serving", None)
        if (self.batcher is None and scfg is not None
                and scfg.query_batch_window_ms > 0):
            from modular_rag_system_tpu_torch.batching import QueryBatcher

            self.batcher = QueryBatcher(
                system.engine,
                window_ms=scfg.query_batch_window_ms,
                max_batch=scfg.query_batch_max,
            )
        batcher = self.batcher

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, payload) -> None:
                body = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                if n == 0:
                    return {}
                try:
                    return json.loads(self.rfile.read(n))
                except json.JSONDecodeError:
                    return None

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok",
                                     "docs": system.engine.index.count,
                                     "tier": system.engine.index.tier})
                elif self.path == "/stats":
                    stats = system.get_system_stats()
                    if batcher is not None:
                        stats["query_batcher"] = dict(batcher.stats)
                    self._send(200, stats)
                elif self.path == "/files":
                    self._send(200, {"files": system.files.list_files()})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                body = self._body()
                if body is None:
                    self._send(400, {"error": "malformed JSON body"})
                    return
                try:
                    if self.path == "/query":
                        if "query" not in body:
                            self._send(400, {"error": "missing 'query'"})
                            return
                        if body.get("enhanced", True):
                            resp = system.enhanced_query(
                                body["query"],
                                current_app=body.get("current_app", ""),
                            )
                            self._send(200, resp)
                        else:
                            threshold = body.get("similarity_threshold")
                            thr = float(threshold) if threshold is not None else None
                            k = int(body.get("max_results", 5))
                            if batcher is not None:
                                res = batcher.submit(
                                    body["query"], max_results=k,
                                    similarity_threshold=thr,
                                )
                            else:
                                res = system.engine.query(
                                    body["query"], max_results=k,
                                    similarity_threshold=thr,
                                )
                            self._send(200, {
                                "query": body["query"],
                                "results": [
                                    {"content": d.content, "source": d.source,
                                     "similarity": s, "id": d.id}
                                    for d, s in zip(res.documents, res.similarities)
                                ],
                                "retrieval_time": res.retrieval_time,
                            })
                    elif self.path == "/add":
                        if "content" not in body:
                            self._send(400, {"error": "missing 'content'"})
                            return
                        ids = system.engine.add_text(
                            body["content"],
                            content_type=body.get("content_type", "document"),
                            source=body.get("source", "api"),
                        )
                        self._send(200, {"ids": ids, "chunks": len(ids)})
                    elif self.path == "/feedback":
                        missing = [k for k in ("query", "type") if k not in body]
                        if missing:
                            self._send(400, {"error": f"missing {missing}"})
                            return
                        system.record_feedback(body["query"], body["type"])
                        self._send(200, {"recorded": True})
                    else:
                        self._send(404, {"error": f"unknown path {self.path}"})
                except Exception as exc:
                    self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

        class Server(ThreadingHTTPServer):
            # default TCP backlog (5) resets connections under bursts of
            # concurrent clients — exactly the load the query batcher is
            # built for
            request_queue_size = 128
            daemon_threads = True

        self._server = Server((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None
