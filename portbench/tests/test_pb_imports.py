"""The import guard: every module the benchmark imports, walked from
``run.py``, the traffic kinds, the metric readers and ``reference/``
(and through the port's own modules), has a top-level name, compared
whole, that is not ``jax``, ``jaxlib``, ``flax`` or the JAX package; the
reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench.common import FORBIDDEN, PB, ROOT

PORT = "modular_rag_system_tpu_torch"
LOCAL = ("portbench", PORT)


def _imports(path: Path):
    """(module, level) of every import statement in a file."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def _file_of(module: str):
    p = ROOT.joinpath(*module.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _walk(start):
    """Every top-level module name reachable from ``start`` files through
    the repo's own modules."""
    seen, todo, tops = set(), list(start), set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        pkg = ".".join(f.relative_to(ROOT).with_suffix("").parts[:-1])
        for mod, level in _imports(f):
            if level:
                base = pkg.split(".")[: len(pkg.split(".")) - level + 1]
                mod = ".".join(base + ([mod] if mod else []))
            top = mod.split(".", 1)[0]
            tops.add(top)
            if top in LOCAL:
                parts = mod.split(".")
                for i in range(len(parts), 0, -1):
                    g = _file_of(".".join(parts[:i]))
                    if g is not None:
                        todo.append(g)
                        break
    return tops, seen


def test_benchmark_reaches_no_jax():
    files = [PB / "run.py", PB / "calibrate.py"]
    files += sorted((PB / "traffic").glob("*.py")) + sorted((PB / "layers").glob("*.py"))
    files += sorted((PB / "reference").glob("*.py"))
    # the port's modules the traffic kinds reach by attribute
    for mod in ("engine", "models/train", "models/__init__",
                "kernels/__init__", "index", "store", "types", "config"):
        files.append(ROOT / PORT / f"{mod}.py")
    tops, seen = _walk(files)
    assert not tops & set(FORBIDDEN), sorted(tops & set(FORBIDDEN))
    # compared whole: the port's name begins with the JAX package's
    assert PORT in tops and len(seen) > 40


def test_reference_imports_nothing_of_the_port():
    tops, seen = _walk(sorted((PB / "reference").glob("*.py")))
    assert PORT not in tops and not tops & set(FORBIDDEN)
    assert all(f.is_relative_to(PB) for f in seen)


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import common, run, calibrate\n"
            "from portbench.reference import bert, train, wordpiece\n"
            "b = common.benchmark()\n"
            "[common.traffic(common.mix(w['traffic'])['kind']) for w in b['workloads']]\n"
            "[common.layer(m['name']) for m in b['per_layer']]\n"
            "import modular_rag_system_tpu_torch.engine\n"
            "import modular_rag_system_tpu_torch.models.train\n"
            "print(common.forbidden_loaded())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_guard_compares_whole_names(monkeypatch):
    from portbench import common

    monkeypatch.setitem(sys.modules, "modular_rag_system_tpu_torch_fake", object())
    assert "modular_rag_system_tpu_torch_fake" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "modular_rag_system_tpu.sub", object())
    assert common.forbidden_loaded() == ["modular_rag_system_tpu.sub"]
