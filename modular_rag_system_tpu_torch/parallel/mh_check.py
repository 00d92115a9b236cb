"""Multi-process self-check of the port's ``torch.distributed`` layer.

Every process of a group runs the same program (SPMD), e.g. two
processes with two index shards each on one machine:

    python -m modular_rag_system_tpu_torch.parallel.mh_check 0 2 127.0.0.1:9876 &
    python -m modular_rag_system_tpu_torch.parallel.mh_check 1 2 127.0.0.1:9876

(``--device cuda`` puts both processes' tensors on the card, ``--shards
N`` gives each process N local shards.)  Checks, in order, each with a
marker on its own line:

  1. bring-up through ``multihost.initialize_multihost``: the group's size
     and the (process, shard) grid of ``global_device_grid``;
  2. a cross-process reduction of device tensors (``all_reduce_sum``):
     right only if data moved between the processes      -> MH_PSUM_OK
  3. ``apply_multihost_defaults``: ``index_shards`` = the global shard
     count, ``dcn_slices`` = the process count            -> MH_DEFAULTS_OK
  4. a small ``ShardedIndex`` across the processes with the same rows
     added in every process (the SPMD ingest contract): exact
     self-retrieval of rows that live on the other process's shards
                                                          -> MH_SHARDED_OK

On success the last line is ``MH_CHECK_OK pid=<i>``.
``spawn_two_process_cluster`` starts both processes of such a check and
waits for them.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence, Tuple

MARKERS = ("MH_PSUM_OK", "MH_DEFAULTS_OK", "MH_SHARDED_OK", "MH_CHECK_OK")


def run_check(process_id: int, num_processes: int, coordinator: str, device: str = "cpu",
              shards: int = 2) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from modular_rag_system_tpu_torch.config import RAGConfig
    from modular_rag_system_tpu_torch.parallel import multihost
    from modular_rag_system_tpu_torch.parallel.sharded import ShardedIndex
    from modular_rag_system_tpu_torch.utils.device import resolve_device

    multihost.initialize_multihost(coordinator, num_processes, process_id)
    assert multihost.is_initialized()
    if multihost.world_size() != num_processes:
        raise AssertionError(f"group of {multihost.world_size()}, not {num_processes}")
    dev = resolve_device(device)
    local = [dev] * shards
    grid = multihost.global_device_grid(local)
    if grid.shape != (num_processes, shards) or [r for r, _ in grid[:, 0]] != list(
            range(num_processes)):
        raise AssertionError(f"device grid {grid.tolist()}")

    # 2. a reduction across the processes, on the device
    x = torch.full((shards,), float(process_id + 1), device=dev)
    total = multihost.all_reduce_sum(x)
    expect = float(shards * sum(range(1, num_processes + 1)))
    val = float(total.sum())
    if val != expect or total.device.type != dev.type:
        raise AssertionError((val, expect, total.device))
    print(f"MH_PSUM_OK pid={process_id} sum={val} device={total.device}", flush=True)

    # 3. mesh defaults from the group
    cfg = RAGConfig()
    multihost.apply_multihost_defaults(cfg, local)
    if cfg.mesh.index_shards != num_processes * shards or (
            num_processes > 1 and cfg.mesh.dcn_slices != num_processes):
        raise AssertionError(cfg.mesh)
    print(f"MH_DEFAULTS_OK pid={process_id} shards={cfg.mesh.index_shards} "
          f"dcn={cfg.mesh.dcn_slices}", flush=True)

    # 4. a sharded index across the processes (same rows in every process)
    group = dist.group.WORLD if num_processes > 1 else None
    idx = ShardedIndex(dim=16, mesh=local, capacity=64, device=dev, group=group)
    rng = np.random.RandomState(0)
    mat = rng.randn(48, 16).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    idx.add(mat)
    probe = [0, 1, 47] if num_processes * shards > 1 else [0, 1]
    scores, rows = idx.search(mat[probe], 3)
    if idx.count != 48 or list(rows[:, 0]) != probe or not (scores[:, 0] > 0.99).all():
        raise AssertionError((idx.count, rows, scores))
    print(f"MH_SHARDED_OK pid={process_id} rows={rows[:, 0].tolist()}", flush=True)
    print(f"MH_CHECK_OK pid={process_id}", flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: Sequence[str], n: int, timeout: float = 120.0,
                cwd: Optional[str] = None, env: Optional[dict] = None
                ) -> List[Tuple[int, str, str]]:
    """Run ``python <argv> <rank> <n> 127.0.0.1:<free port>`` as ``n``
    processes at once and wait for all of them, at most ``timeout``
    seconds in all (then every one still running is killed).  Output goes
    through files, so no pipe fills while another rank is waited on.
    Returns [(rc, stdout, stderr)] in rank order; raises RuntimeError when
    one times out or exits non-zero."""
    import time

    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ if env is None else env)
    procs, files = [], []
    try:
        for r in range(n):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv, str(r), str(n), coord],
                                          cwd=cwd, env=env, text=True, stdout=out,
                                          stderr=err))
        deadline = time.monotonic() + timeout
        timed_out = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    failed = [(r, rc, so, se) for r, (rc, so, se) in enumerate(results) if rc != 0]
    if timed_out or failed:
        detail = "\n".join(f"rank {r} rc={rc}:\n{so[-1500:]}\n{se[-3000:]}"
                           for r, rc, so, se in failed)
        raise RuntimeError(f"{n}-process run of {argv} "
                           f"{'timed out after ' + str(timeout) + ' s' if timed_out else 'failed'}"
                           f":\n{detail}")
    return results


def spawn_two_process_cluster(device: str = "cpu", shards_per_process: int = 2,
                              timeout: float = 120.0, repo_dir: Optional[str] = None
                              ) -> List[Tuple[int, str, str]]:
    """Both processes of a 2-process check of this module, tensors on
    ``device``; raises RuntimeError if either fails, times out or misses
    a marker.  Returns [(rc, stdout, stderr)] in rank order."""
    cwd = repo_dir or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    results = spawn_ranks(["-m", "modular_rag_system_tpu_torch.parallel.mh_check",
                           "--device", device, "--shards", str(shards_per_process)],
                          2, timeout=timeout, cwd=cwd)
    for r, (_, out, err) in enumerate(results):
        missing = [m for m in MARKERS if m not in out]
        if missing:
            raise RuntimeError(f"rank {r} printed no {missing}:\n{out[-1500:]}\n{err[-2000:]}")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m modular_rag_system_tpu_torch.parallel.mh_check",
                                description="multi-process self-check (run one per rank)")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--shards", type=int, default=2, help="index shards per process")
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("coordinator", help="host:port of rank 0's store")
    args = p.parse_args(argv)
    run_check(args.process_id, args.num_processes, args.coordinator, args.device, args.shards)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
