"""Multi-process bring-up over ``torch.distributed``, and the collectives
the layers above need.

Single-process use is unchanged (nothing here runs unless asked).  For a
multi-process deployment each process runs the SAME program (launcher
``--multihost`` or ``RAGConfig.mesh.multihost = True``):

    RAG_COORDINATOR=host0:8476 RAG_NUM_PROCESSES=2 RAG_PROCESS_ID=0 \\
        python -m modular_rag_system_tpu_torch.launcher --multihost --daemon

Under ``torchrun`` the three variables may be omitted: ``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` take their place (the
counterpart of the JAX package's auto-detection on TPU pods).

One process drives its own devices, and the group's ranks are the
processes: rank r's local shards are the index shards ``r * P .. r * P +
P - 1`` of a layout whose slices are the processes (``parallel/
sharded.py``), and the trainer's (data, model) layout is laid over the
ranks (``parallel/mesh.py make_train_mesh``).

The backend is gloo: it runs on a host CPU and with several ranks on one
card, where NCCL refuses two ranks.  The collectives stage device tensors
through the host, as raw bytes, and reduce in rank order, so every rank
gets bit-identical results.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

ENV_COORD = "RAG_COORDINATOR"
ENV_NPROC = "RAG_NUM_PROCESSES"
ENV_PID = "RAG_PROCESS_ID"
# how long a rank waits for the others, at bring-up and in a collective
TIMEOUT_S = 300.0


def is_initialized() -> bool:
    """True once a default process group is live (ours or anyone's)."""
    return dist.is_available() and dist.is_initialized()


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Join the process group (idempotent): gloo, ``tcp://coordinator``.

    Each value resolves from its argument, then ``RAG_COORDINATOR`` /
    ``RAG_NUM_PROCESSES`` / ``RAG_PROCESS_ID``, then torchrun's
    ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``; a value that
    none gives raises.  ``num_processes=1`` is a legitimate smoke
    configuration (the whole bring-up path on one process).  Returns True
    when a group is live after the call."""
    if is_initialized():
        logger.info("torch.distributed already initialized; skipping")
        return True
    if not coordinator:
        coordinator = os.environ.get(ENV_COORD) or None
    if not coordinator and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int(ENV_NPROC, "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int(ENV_PID, "RANK")
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(
            f"multihost bring-up needs {', '.join(missing)}: pass them, or set "
            f"{ENV_COORD}/{ENV_NPROC}/{ENV_PID} (or torchrun's MASTER_ADDR, MASTER_PORT, "
            f"WORLD_SIZE, RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    logger.info("torch.distributed initialized: rank %d of %d (gloo, %s)",
                process_id, num_processes, coordinator)
    return True


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: the default group); 1 with no group."""
    return dist.get_world_size(group) if is_initialized() else 1


# ---------------------------------------------------------------------------
def device_grid(entries: Iterable[Tuple[int, object]]) -> np.ndarray:
    """(rank, device) entries -> the (n_processes, per_process) object
    grid of the entries, rows in rank order, each row in the order given.
    Uneven per-rank counts raise."""
    by_rank: dict = {}
    for r, d in entries:
        by_rank.setdefault(r, []).append((r, d))
    counts = {len(v) for v in by_rank.values()}
    if len(counts) != 1:
        raise ValueError(
            f"uneven devices per process: { {r: len(v) for r, v in by_rank.items()} }")
    grid = np.empty((len(by_rank), counts.pop()), dtype=object)
    for i, r in enumerate(sorted(by_rank)):
        for j, e in enumerate(by_rank[r]):
            grid[i, j] = e
    return grid


def global_device_grid(local_devices: Sequence) -> np.ndarray:
    """The group's devices as a (n_processes, per_process) grid of
    ``(rank, device name)``, rows in rank order: every rank's
    ``local_devices`` (its index shards' devices), gathered.  Without a
    group: one row, this process's devices."""
    local = [str(d) for d in local_devices]
    if not is_initialized():
        return device_grid((0, d) for d in local)
    gathered: List = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    return device_grid((r, d) for r, devs in enumerate(gathered) for d in devs)


def apply_multihost_defaults(cfg, local_devices: Sequence) -> None:
    """Fill mesh-config defaults from the group: an unconfigured
    ``index_shards`` (<= 1) becomes the global shard count, and
    ``dcn_slices`` the process count when there are several.  Explicit
    values are left untouched."""
    n_proc, per_proc = global_device_grid(local_devices).shape
    if cfg.mesh.index_shards <= 1:
        cfg.mesh.index_shards = n_proc * per_proc
    if cfg.mesh.dcn_slices <= 1 and n_proc > 1:
        cfg.mesh.dcn_slices = n_proc
    logger.info("multihost mesh defaults: index_shards=%d dcn_slices=%d "
                "(%d process(es) x %d shard(s))",
                cfg.mesh.index_shards, cfg.mesh.dcn_slices, n_proc, per_proc)


def ensure_multihost(cfg, local_devices: Sequence) -> None:
    """Engine hook: join the group (config, then environment) and derive
    the mesh defaults.  Called when ``cfg.mesh.multihost`` is set."""
    initialize_multihost(
        coordinator=cfg.mesh.coordinator or None,
        num_processes=cfg.mesh.num_processes or None,
        process_id=cfg.mesh.process_id if cfg.mesh.process_id >= 0 else None,
    )
    apply_multihost_defaults(cfg, local_devices)


# ---------------------------------------------------------------------------
# collectives: device tensors go through the host as raw bytes (gloo takes
# CPU tensors on every build), results come back on the input's device
def _all_gather_bytes(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on every rank), in the
    group's rank order, on ``t``'s device."""
    host = t.detach().contiguous().cpu()
    flat = host.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(group_size(group))]
    dist.all_gather(parts, flat, group=group)
    return [p.view(t.dtype).reshape(t.shape).to(t.device) for p in parts]


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` in rank order (``[t]`` alone in a group of one)."""
    if group_size(group) == 1:
        return [t]
    return _all_gather_bytes(t, group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order (bit-identical
    on every rank); ``t`` itself in a group of one.  Use one flat buffer
    for many tensors: one collective."""
    parts = all_gather(t, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def all_gather_candidates(vals: torch.Tensor, gids: torch.Tensor, group=None
                          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every rank's (Q, k) f32 scores and int32 ids, in rank order, in one
    collective of Q * k * 8 bytes a rank."""
    if group_size(group) == 1:
        return [(vals, gids)]
    packed = torch.cat([vals.float().contiguous().view(torch.int32),
                        gids.to(torch.int32)], dim=1)
    k = vals.shape[1]
    return [(p[:, :k].contiguous().view(torch.float32), p[:, k:].contiguous())
            for p in _all_gather_bytes(packed, group)]


def barrier(group=None) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)
