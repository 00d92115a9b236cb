"""The port's multi-process layer (``parallel/multihost.py``,
``parallel/mh_check.py``, the engine's ``mesh.multihost``) on the CPU.

The port's counterparts of ``tests/test_multihost.py``.  No test joins a
process group in the pytest process: every multi-rank case runs in child
processes (gloo on the CPU, each run with its own timeout), so no group
outlives its test.

The two-process engine case: two ranks of one gloo group, each holding
two CPU shards of a 2 x 2 layout whose slices are the processes
(``tests/torch_mh_child.py``), answer the same queries as the JAX
engine on a (2, 2) hierarchical mesh of the 8 virtual CPU devices and
the port's one-process 2 x 2 engine, for the exact, fused, bf16 and int8
tiers.  Ids equal exactly, tie order included; similarities within 1e-5
(``tests/torch_parity.assert_same_fields``).  The encoder's output is
rounded to bf16-representable values in every engine, so the fused and
bf16 tiers see the same products in both packages (as in
``test_torch_sharded.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from modular_rag_system_tpu_torch import RAGConfig, create_engine
from modular_rag_system_tpu_torch.parallel import multihost
from modular_rag_system_tpu_torch.parallel.mh_check import (
    MARKERS,
    free_port,
    spawn_ranks,
    spawn_two_process_cluster,
)
from modular_rag_system_tpu_torch.types import Document
from tests import torch_mh_child as child
from tests.torch_parity import assert_same_fields

REPO = str(Path(__file__).resolve().parents[1])
_ENV_KEYS = ("RAG_COORDINATOR", "RAG_NUM_PROCESSES", "RAG_PROCESS_ID", "MASTER_ADDR",
             "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_global_device_grid_without_a_group():
    grid = multihost.global_device_grid(["cpu"] * 3)
    # one process: one row, every local device in it
    assert grid.shape == (1, 3)
    assert list(grid[0]) == [(0, "cpu")] * 3


def test_device_grid_rejects_uneven():
    with pytest.raises(ValueError, match="uneven"):
        multihost.device_grid([(0, "cuda:0"), (0, "cuda:1"), (1, "cuda:0")])


def test_device_grid_orders_processes():
    grid = multihost.device_grid([(1, "b0"), (0, "a0"), (1, "b1"), (0, "a1")])
    assert grid.shape == (2, 2)
    assert [d for _, d in grid[0]] == ["a0", "a1"]
    assert [d for _, d in grid[1]] == ["b0", "b1"]


def test_apply_multihost_defaults_fills_unset():
    cfg = RAGConfig()
    assert cfg.mesh.index_shards == 1
    multihost.apply_multihost_defaults(cfg, ["cpu"] * 4)
    assert cfg.mesh.index_shards == 4
    # one process: dcn_slices untouched
    assert cfg.mesh.dcn_slices == 1


def test_apply_multihost_defaults_respects_explicit():
    cfg = RAGConfig()
    cfg.mesh.index_shards = 2  # an explicit choice survives
    multihost.apply_multihost_defaults(cfg, ["cpu"] * 4)
    assert cfg.mesh.index_shards == 2


def test_config_mesh_multihost_fields_roundtrip():
    cfg2 = RAGConfig().merged({"mesh": {"multihost": True, "coordinator": "h0:1234",
                                        "num_processes": 4, "process_id": 2}})
    assert (cfg2.mesh.multihost, cfg2.mesh.coordinator, cfg2.mesh.num_processes,
            cfg2.mesh.process_id) == (True, "h0:1234", 4, 2)
    assert RAGConfig().mesh.multihost is False  # the original is untouched


def test_launcher_multihost_flag_sets_config():
    from modular_rag_system_tpu_torch.launcher import build_arg_parser, load_config

    assert load_config(build_arg_parser().parse_args(["--multihost", "--init-only"])
                       ).mesh.multihost is True
    assert load_config(build_arg_parser().parse_args(["--init-only"])).mesh.multihost is False


def test_bring_up_without_a_coordinator_raises(monkeypatch):
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize_multihost(num_processes=1, process_id=0)
    with pytest.raises(ValueError, match="outside"):
        multihost.initialize_multihost("127.0.0.1:1", 2, 2)
    assert not multihost.is_initialized()


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _ENV_KEYS}
    env.update(extra)
    return env


@pytest.mark.parametrize("style", ["rag", "torchrun"])
def test_one_process_bring_up_subprocess(style):
    """The whole bring-up with one process in a fresh interpreter, from
    the RAG_* variables or from torchrun's."""
    port = free_port()
    env = (_env(RAG_COORDINATOR=f"127.0.0.1:{port}", RAG_NUM_PROCESSES="1",
                RAG_PROCESS_ID="0") if style == "rag" else
           _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0"))
    prog = (
        "from modular_rag_system_tpu_torch.config import RAGConfig\n"
        "from modular_rag_system_tpu_torch.parallel import multihost as mh\n"
        "assert mh.initialize_multihost() and mh.is_initialized()\n"
        "assert mh.initialize_multihost()  # idempotent\n"
        "assert (mh.world_size(), mh.rank()) == (1, 0)\n"
        "cfg = RAGConfig(); cfg.mesh.multihost = True\n"
        "mh.apply_multihost_defaults(cfg, ['cpu'] * 4)\n"
        "assert (cfg.mesh.index_shards, cfg.mesh.dcn_slices) == (4, 1), cfg.mesh\n"
        "print('MULTIHOST_OK')\n")
    proc = subprocess.run([sys.executable, "-c", prog], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "MULTIHOST_OK" in proc.stdout


@pytest.mark.parametrize("shards", [None, 2])
def test_launcher_multihost_init_only(tmp_path, shards):
    """``launcher --multihost --init-only`` with the RAG_* variables: a
    1-process group; its engine's index is the one-process layout."""
    env = _env(RAG_COORDINATOR=f"127.0.0.1:{free_port()}", RAG_NUM_PROCESSES="1",
               RAG_PROCESS_ID="0")
    cmd = [sys.executable, "-m", "modular_rag_system_tpu_torch.launcher", "--multihost",
           "--init-only", "--device", "cpu", "--encoder", "fake", "--port", "0",
           "--storage", str(tmp_path)]
    if shards:
        cmd += ["--shards", str(shards)]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    stats = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert stats["engine"]["index"]["count"] == 0
    assert stats["engine"]["index"]["device"] == "cpu"
    assert (tmp_path / "index.npz").exists()  # shutdown wrote its snapshot


def test_two_process_cluster():
    """Two processes x 2 CPU shards: bring-up, a reduction across the
    processes, the defaults' dcn_slices = 2 branch, and a ShardedIndex
    whose rows live on the other process's shards."""
    results = spawn_two_process_cluster(device="cpu", shards_per_process=2, timeout=120,
                                        repo_dir=REPO)
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-2000:]
        for marker in MARKERS:
            assert marker in out, (marker, out, err[-1000:])
        assert f"MH_CHECK_OK pid={r}" in out.strip().splitlines()[-1]
        assert "shards=4 dcn=2" in out


def test_spawn_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 rc=3"):
        spawn_ranks(["-c", "import sys; sys.exit(3 if sys.argv[1] == '1' else 0)"], 2,
                    timeout=60)


# ---------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Per tier: the two ranks' answers (child processes), the JAX
    engine's on the (2, 2) hierarchical mesh, the port's one-process 2 x 2
    engine's."""
    from modular_rag_system_tpu.config import RAGConfig as JaxConfig
    from modular_rag_system_tpu.engine import RAGEngine as JaxEngine
    from modular_rag_system_tpu.parallel.sharded import ShardedIndex as JaxSharded
    from modular_rag_system_tpu.types import Document as JaxDocument

    root = tmp_path_factory.mktemp("mh_engines")
    spawn_ranks(["-m", "tests.torch_mh_child", "engine", str(root)], 2, timeout=120, cwd=REPO)
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in (0, 1)]
    layout = {"index.tier": None, "mesh.index_shards": 4, "mesh.dcn_slices": 2}
    jax_out, one_out = {}, {}
    for tier in child.TIERS:
        over = {**layout, "index.tier": tier}
        jeng = child.bf16_encoder(JaxEngine(JaxConfig.load(
            overrides=child.fake_overrides(root / "jax" / tier, **over))))
        assert isinstance(jeng.index, JaxSharded) and jeng.index.mesh.devices.shape == (2, 2)
        jax_out[tier] = child.drive_engine(jeng, JaxDocument, deep=tier == "exact")
        jeng.shutdown()
        peng = child.bf16_encoder(create_engine(RAGConfig.load(
            overrides=child.fake_overrides(root / "one" / tier, **over)), device="cpu"))
        assert peng.index.hierarchical and peng.index.S == 4
        one_out[tier] = child.drive_engine(peng, Document, deep=tier == "exact")
        peng.shutdown()
    return ranks, jax_out, one_out


def _answers(rank_report, tier):
    return {k: v for k, v in rank_report["tiers"][tier].items()
            if k not in ("count", "effective_tier")}


@pytest.mark.parametrize("tier", child.TIERS)
def test_two_process_engine_matches_jax(engines, tier):
    ranks, jax_out, _ = engines
    for r in ranks:
        assert_same_fields(jax_out[tier], _answers(r, tier))


@pytest.mark.parametrize("tier", child.TIERS)
def test_two_process_engine_matches_one_process(engines, tier):
    ranks, _, one_out = engines
    for r in ranks:
        assert_same_fields(one_out[tier], _answers(r, tier))
        assert r["tiers"][tier]["effective_tier"] == tier


def test_ranks_agree_bit_for_bit(engines):
    ranks, _, _ = engines
    assert ranks[0]["tiers"] == ranks[1]["tiers"]
    assert ranks[0]["tiers"]["exact"]["count"] == len(child.CORPUS) + len(child.FILLER) + 3
    # (index_shards, dcn_slices, S, first global shard, local shards):
    # the defaults filled from the group, each rank its own slice
    assert [r["layout"] for r in ranks] == [[4, 2, 4, 0, 2], [4, 2, 4, 2, 2]]


@pytest.mark.parametrize("what", ["build_ann", "snapshot", "load", "shutdown"])
def test_across_processes_build_and_snapshot_raise(engines, what):
    # as in JAX, whose multihost index cannot fetch a global array that
    # spans another process's devices (the engine's shutdown snapshots)
    ranks, _, _ = engines
    for r in ranks:
        msg = r["errors"][what]
        assert msg is not None and "across processes" in msg and "JAX" in msg, msg
