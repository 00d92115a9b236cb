"""Building the system under test from a configuration file: its
settings, its filler corpus, a seeded HF checkpoint, and the check of
the route a cell takes.  The program is imported inside these
functions only."""

from __future__ import annotations

import json
import struct
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np

from portbench import data
from portbench.common import log


def rag_config(cfg: Dict[str, Any], storage: Path, extra: Dict[str, Any] = None):
    """The configuration's engine settings as a ``RAGConfig``, its store
    under ``storage``; no snapshot at shutdown, no fixed ports."""
    from modular_rag_system_tpu_torch.config import RAGConfig

    overrides = dict(cfg["engine"])
    overrides.update(extra or {})
    overrides.update({"store.storage_path": str(storage),
                      "store.snapshot_on_shutdown": False,
                      "serving.file_server_port": 0})
    return RAGConfig.load(overrides=overrides)


def fill(eng, seed: int, target: int) -> None:
    """Seeded unit filler rows (pre-embedded documents with explicit ids
    in row order) up to ``target`` rows; the first append tops the count
    up to a multiple of the fill block, so the index's pow-2 padded
    appends keep its capacity a power of two."""
    from modular_rag_system_tpu_torch.types import Document

    t0 = time.perf_counter()
    dim = eng.index.dim
    f = 0  # next filler index
    block, block_start = None, -1
    while eng.index.count < target:
        n = min(data.FILL_BLOCK - eng.index.count % data.FILL_BLOCK, target - eng.index.count)
        parts = []
        done = 0
        while done < n:
            b0 = (f + done) // data.FILL_BLOCK * data.FILL_BLOCK
            if b0 != block_start:
                block = data.filler_block(seed, b0, data.FILL_BLOCK, dim, eng.device).cpu().numpy()
                block_start = b0
            lo = f + done - b0
            take = min(n - done, data.FILL_BLOCK - lo)
            parts.append(block[lo:lo + take])
            done += take
        x = np.concatenate(parts) if len(parts) > 1 else parts[0]
        eng.add_documents([Document(content=data.filler_content(f + i), source="filler",
                                    timestamp=data.FILLER_TS, embedding=x[i],
                                    id=data.filler_id(f + i))
                           for i in range(n)])
        f += n
    dt = time.perf_counter() - t0
    log(f"filler: {f} rows in {dt:.1f} s ({f / max(dt, 1e-9):.0f} rows/s); "
        f"count {eng.index.count}, capacity {eng.index.capacity}")


def check_route(route: Dict[str, Any], eng, launches: Dict[str, int]) -> None:
    """Fail the run unless the warm-up took the route the cell names:
    the kernels it must launch did, those it must not did not, and the
    index serves the tier it names."""
    if not route:
        return
    missing = [k for k in route.get("launch", []) if launches.get(k, 0) == 0]
    extra = [k for k in route.get("no_launch", []) if launches.get(k, 0) > 0]
    tier = route.get("tier")
    got_tier = eng.index.effective_tier()
    if missing or extra or (tier and got_tier != tier):
        raise RuntimeError(f"the warm-up took another route than the cell's: launches "
                           f"{launches}, tier {got_tier}; the cell wants {route}")
    log(f"route: tier {got_tier}, launches {launches}")


def write_hf_checkpoint(out: Path, hf_config: dict, vocab: Dict[str, int], weights) -> Path:
    """A local HF BERT checkpoint written by hand (``config.json``,
    ``vocab.txt``, ``model.safetensors`` in F32) from tensors the
    benchmark made."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(hf_config, indent=1))
    (out / "vocab.txt").write_text("".join(p + "\n" for p, _ in
                                           sorted(vocab.items(), key=lambda kv: kv[1])))
    header, blobs, offset = {}, [], 0
    for name in sorted(weights):
        t = weights[name].detach().float().cpu().contiguous()
        raw = t.numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(out / "model.safetensors", "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for raw in blobs:
            fh.write(raw)
    return out
