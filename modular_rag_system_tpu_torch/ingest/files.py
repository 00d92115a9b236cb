"""File upload manager + embedded HTTP file server.

Parity with the reference ``FileUploadManager``
(``enhanced_rag_system.py:638-845``): files are copied into
``uploads/{json,txt,processed}/`` as ``{file_id}_{name}`` with a sha256
content hash recorded in metadata; ``upload_folder_contents`` recursively
ingests ``.json``/``.txt`` (plus ``.md`` here); a daemon-thread
``HTTPServer`` serves ``GET /files`` (JSON listing) and
``GET /files/<file_id>/<filename>`` with permissive CORS, so retrieved
results can link back to their source files (``access_link``).
"""

from __future__ import annotations

import hashlib
import json
import mimetypes
import shutil
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Dict, List, Optional

_TEXT_SUFFIXES = (".txt", ".json", ".md")


@dataclass
class UploadedFile:
    """Reference ``UploadedFile`` (``enhanced_rag_system.py:601-619``)."""

    file_id: str
    original_name: str
    stored_path: str
    content_type: str
    size_bytes: int
    sha256: str
    uploaded_at: float = field(default_factory=time.time)

    @property
    def access_link(self) -> str:
        return f"/files/{self.file_id}/{self.original_name}"

    def to_dict(self) -> Dict:
        return {
            "file_id": self.file_id,
            "original_name": self.original_name,
            "content_type": self.content_type,
            "size_bytes": self.size_bytes,
            "sha256": self.sha256,
            "uploaded_at": self.uploaded_at,
            "access_link": self.access_link,
        }


class FileUploadManager:
    def __init__(self, upload_folder: str = "uploads", port: int = 8089) -> None:
        self.root = Path(upload_folder)
        for sub in ("json", "txt", "processed"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)
        self.port = port
        self.files: Dict[str, UploadedFile] = {}
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def add_file(self, path: str) -> Optional[UploadedFile]:
        src = Path(path)
        if not src.is_file():
            return None
        file_id = uuid.uuid4().hex[:8]
        sub = "json" if src.suffix == ".json" else "txt" if src.suffix in (".txt", ".md") else "processed"
        dst = self.root / sub / f"{file_id}_{src.name}"
        shutil.copy2(src, dst)
        digest = hashlib.sha256(dst.read_bytes()).hexdigest()
        rec = UploadedFile(
            file_id=file_id,
            original_name=src.name,
            stored_path=str(dst),
            content_type=mimetypes.guess_type(src.name)[0] or "application/octet-stream",
            size_bytes=dst.stat().st_size,
            sha256=digest,
        )
        with self._lock:
            self.files[file_id] = rec
        return rec

    def upload_folder_contents(self, folder: str) -> List[UploadedFile]:
        """Recursively ingest text-like files (reference rglob of

        ``*.json``/``*.txt``, ``enhanced_rag_system.py:808``)."""
        out = []
        base = Path(folder)
        if not base.is_dir():
            return out
        for p in sorted(base.rglob("*")):
            if p.is_file() and p.suffix in _TEXT_SUFFIXES and self.root not in p.parents:
                rec = self.add_file(str(p))
                if rec:
                    out.append(rec)
        return out

    # ------------------------------------------------------------------
    def list_files(self) -> List[Dict]:
        with self._lock:
            return [f.to_dict() for f in self.files.values()]

    def get_file(self, file_id: str) -> Optional[UploadedFile]:
        with self._lock:
            return self.files.get(file_id)

    def get_file_link(self, file_id: str) -> Optional[str]:
        rec = self.get_file(file_id)
        return rec.access_link if rec else None

    def find_relevant_files(self, query: str, top: int = 3) -> List[UploadedFile]:
        """Filename-overlap relevance (reference ``enhanced_rag_system.py``

        file-reference scoring): rank by shared lowercase words."""
        qwords = set(query.lower().split())
        scored = []
        with self._lock:
            for f in self.files.values():
                name_words = set(
                    f.original_name.lower().replace("_", " ").replace("-", " ")
                    .rsplit(".", 1)[0].split()
                )
                overlap = len(qwords & name_words)
                if overlap:
                    scored.append((overlap, f))
        scored.sort(key=lambda t: -t[0])
        return [f for _, f in scored[:top]]

    # ------------------------------------------------------------------
    def start_web_server(self) -> int:
        """Start the daemon HTTP server; returns the bound port."""
        if self._server is not None:
            return self.port
        manager = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _cors(self):
                self.send_header("Access-Control-Allow-Origin", "*")

            def do_GET(self):
                parts = [p for p in self.path.split("/") if p]
                if parts == ["files"]:
                    body = json.dumps({"files": manager.list_files()}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self._cors()
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if len(parts) == 3 and parts[0] == "files":
                    rec = manager.get_file(parts[1])
                    if rec and Path(rec.stored_path).is_file():
                        data = Path(rec.stored_path).read_bytes()
                        self.send_response(200)
                        self.send_header("Content-Type", rec.content_type)
                        self._cors()
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                        return
                self.send_response(404)
                self._cors()
                self.end_headers()

        # port 0 = ephemeral (tests); real deployments pass 8089
        self._server = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop_web_server(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None

    # ------------------------------------------------------------------
    def read_text(self, rec: UploadedFile) -> str:
        p = Path(rec.stored_path)
        if rec.content_type == "application/json" or p.suffix == ".json":
            try:
                return json.dumps(json.loads(p.read_text()), indent=2)
            except Exception:
                pass
        return p.read_text(errors="replace")
