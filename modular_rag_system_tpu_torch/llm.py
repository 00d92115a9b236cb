"""LLM handoff clients (host-side HTTP / subprocess, exactly as in the

reference: generation never runs on the device retrieval path).

* ``OllamaClient`` — ``POST {base}/api/generate`` with availability
  probing via ``GET /api/tags`` (reference ``embedding_pipeline.py:343-353``
  probing pattern; generation endpoint as used by the external
  OllamaPromptSystem the reference imported from ``../Screenshare``).
* ``Llama3CliClient`` — subprocess wrapper for a local llama3 CLI binary
  (the reference's ``llama3-cli/`` submodule was an empty placeholder;
  this client activates only when a binary is actually present).

Both degrade gracefully: ``available`` is False and ``generate`` returns
None when the backend is unreachable — the query processor then skips
the AI-analysis step (fallback-chain pattern, SURVEY §5).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import urllib.error
import urllib.request
from typing import Optional


class OllamaClient:
    def __init__(
        self,
        base_url: str = "http://localhost:11434",
        model: str = "llama3.2:3b",
        timeout_s: float = 30.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout_s = timeout_s
        self.available = self._probe()

    def _probe(self) -> bool:
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/api/tags", timeout=min(self.timeout_s, 2.0)
            ) as r:
                return r.status == 200
        except Exception:
            return False

    def generate(self, prompt: str) -> Optional[str]:
        if not self.available:
            return None
        payload = json.dumps(
            {"model": self.model, "prompt": prompt, "stream": False}
        ).encode()
        req = urllib.request.Request(
            f"{self.base_url}/api/generate",
            data=payload,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read()).get("response")
        except Exception:
            self.available = self._probe()
            return None


class Llama3CliClient:
    def __init__(self, binary: str = "llama3-cli", model_path: Optional[str] = None,
                 timeout_s: float = 60.0) -> None:
        self.binary = shutil.which(binary)
        self.model_path = model_path
        self.timeout_s = timeout_s
        self.available = self.binary is not None

    def generate(self, prompt: str) -> Optional[str]:
        if not self.available:
            return None
        cmd = [self.binary]
        if self.model_path:
            cmd += ["--model", self.model_path]
        cmd += ["--prompt", prompt]
        try:
            out = subprocess.run(
                cmd, capture_output=True, text=True, timeout=self.timeout_s
            )
            return out.stdout.strip() if out.returncode == 0 else None
        except Exception:
            return None


def build_llm_client(config) -> Optional[object]:
    """Preference chain: Ollama -> llama3-cli -> None (no LLM)."""
    ollama = OllamaClient(
        base_url=config.serving.ollama_base_url,
        model=config.serving.ollama_model,
        timeout_s=config.serving.llm_timeout_s,
    )
    if ollama.available:
        return ollama
    cli = Llama3CliClient(timeout_s=config.serving.llm_timeout_s)
    if cli.available:
        return cli
    return None
