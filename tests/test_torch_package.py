"""Boundaries of the PyTorch port: it imports neither JAX, flax nor the
JAX package (not even its host-only modules), nor the HF libraries
(``transformers``, ``safetensors``, ``huggingface_hub``: the card's
machine has none of them), and neither does the chip smoke script."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "modular_rag_system_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "modular_rag_system_tpu", "transformers",
             "safetensors", "huggingface_hub")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, modular_rag_system_tpu_torch.engine, "
            "modular_rag_system_tpu_torch.ops.binmax_topk, "
            "modular_rag_system_tpu_torch.facade, modular_rag_system_tpu_torch.serving, "
            "modular_rag_system_tpu_torch.launcher, modular_rag_system_tpu_torch.pipeline, "
            "modular_rag_system_tpu_torch.llm, modular_rag_system_tpu_torch.models.train, "
            "modular_rag_system_tpu_torch.models.corpus, modular_rag_system_tpu_torch.models.synth, "
            "modular_rag_system_tpu_torch.models.wordpiece_train, "
            "modular_rag_system_tpu_torch.tools.build_default_encoder, "
            "modular_rag_system_tpu_torch.tools.build_lexical_assets, "
            "modular_rag_system_tpu_torch.parallel.mesh, "
            "modular_rag_system_tpu_torch.parallel.sharded, "
            "modular_rag_system_tpu_torch.parallel.multihost, "
            "modular_rag_system_tpu_torch.parallel.mh_check, "
            "modular_rag_system_tpu_torch.models.hf_loader, "
            "modular_rag_system_tpu_torch.models.external_eval, "
            "modular_rag_system_tpu_torch.native; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_every_kernel_has_its_source():
    from modular_rag_system_tpu_torch import kernels

    for name in kernels.SOURCES:
        assert (kernels.KERNEL_DIR / f"{name}.cu").is_file()


def test_kernel_argtypes_match_c_entry_points():
    # ctypes passes arguments past ``argtypes`` as C ints, which cuts a
    # pointer: every entry point's declared C parameters must match
    import ctypes
    import re

    from modular_rag_system_tpu_torch import kernels

    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    for name, src in kernels.KERNELS.items():
        text = (kernels.KERNEL_DIR / f"{src}.cu").read_text()
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m, f"{src}.cu has no entry point {name}"
        params = [re.sub(r"\bconst\b|\s+", "", p).rsplit("*", 1)[0] + "*"
                  if "*" in p else p.split()[-2] for p in m.group(1).split(",")]
        assert [ctype[p] for p in params] == kernels._ARGTYPES[name], name


def test_kernel_library_builds_only_its_source(monkeypatch):
    # a kernel's first use compiles and loads the one source that holds
    # it, and registers that source's every entry point
    import ctypes
    import types

    from modular_rag_system_tpu_torch import kernels

    built, loaded = [], []

    def fake_build(sources):
        built.append(list(sources))
        return {s: kernels.BUILD_DIR / f"{s}.so" for s in sources}

    def fake_cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(**{n: types.SimpleNamespace() for n in kernels.KERNELS})

    monkeypatch.setattr(kernels, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(kernels, "_libs", {})
    lib = kernels.library("clip_adamw_apply")
    assert built == [["clip_adamw"]] and len(loaded) == 1
    assert set(kernels._libs) == {"clip_adamw_norm", "clip_adamw_apply"}
    assert kernels.library("clip_adamw_norm") is lib and len(built) == 1
    assert lib.clip_adamw_norm.argtypes == kernels._ARGTYPES["clip_adamw_norm"]
