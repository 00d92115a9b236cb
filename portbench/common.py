"""What every part of the benchmark shares: paths, discovery by name, the
device and its published peaks, and the guard against the JAX package.

A run finds each piece by the name ``BENCHMARK.json`` gives it:

* ``workloads/<cell>.json``: the cell (its configuration, its traffic mix,
  the route it must take, parameters that override the mix's);
* ``configs/<config>.json``: the configuration as it is run;
* ``mixes/<mix>.json``: the traffic mix, whose ``kind`` names the driver;
* ``traffic/<kind>.py``: the driver of that kind of traffic;
* ``layers/<metric>.py``: the reader of one per-layer metric.

Nothing here imports the program or the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

PB = Path(__file__).resolve().parent
ROOT = PB.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# the bundled data files the program reads, read here by path only
ASSETS = ROOT / "modular_rag_system_tpu" / "assets"

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "modular_rag_system_tpu")

# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".portbench_cache"


def read_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def benchmark() -> Dict[str, Any]:
    return read_json(BENCHMARK)


def _by_name(folder: str, name: str, suffix: str) -> Path:
    path = PB / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    return path


def cell(name: str) -> Dict[str, Any]:
    return read_json(_by_name("workloads", name, ".json"))


def config(name: str) -> Dict[str, Any]:
    return read_json(_by_name("configs", name, ".json"))


def mix(name: str) -> Dict[str, Any]:
    return read_json(_by_name("mixes", name, ".json"))


def _load(path: Path, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str) -> ModuleType:
    return _load(_by_name("traffic", kind, ".py"), f"portbench.traffic.{kind}")


def layer(metric: str) -> ModuleType:
    return _load(_by_name("layers", metric, ".py"),
                 "portbench.layers." + metric.replace(".", "__"))


def end_to_end_for(bench: Dict[str, Any], cell_name: str) -> List[Dict[str, Any]]:
    """The end-to-end metrics a cell reports: those that list it, and
    those that list no cells."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer_for(bench: Dict[str, Any], cell_name: str) -> List[Dict[str, Any]]:
    """The per-layer metrics a cell reports: those that list it, and
    those that list no cells but move an end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end_for(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def forbidden_loaded() -> List[str]:
    """Modules of the JAX stack or the JAX package in this process,
    compared by their whole top-level name (the port's name begins with
    the JAX package's, so a prefix match would be wrong)."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


def set_cache_env() -> None:
    """Point every build and kernel cache the program may use at a fixed
    directory inside the checkout, and keep libraries from loading JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# published dense peaks (NVIDIA data sheets, no sparsity) of the card
# variants nvidia-smi may name: HBM bytes/s, int8 ops/s, bf16 FLOP/s
SPECS = {
    "H100 PCIe": {"bytes": 2.0e12, "int8": 1513e12, "bf16": 756e12},
    "H100 NVL": {"bytes": 3.9e12, "int8": 1671e12, "bf16": 835e12},
    "H100": {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12},  # SXM
}


def spec_for(kind: str) -> Dict[str, float]:
    for key, spec in SPECS.items():
        if key in kind:
            return spec
    raise RuntimeError(f"no published peaks for {kind!r}")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
