"""Shard layouts of the sharded index: which device holds each shard.

The JAX package builds a ``Mesh`` of devices and runs one ``shard_map``
program over it.  The port runs one process that holds each shard's
tensors on that shard's device, so a layout is a list of
``torch.device``s: flat for ``make_index_mesh``, (slices, chips) nested
lists for ``make_hierarchical_index_mesh``, whose merge runs within each
slice first and then across slices.

``devices`` may be given, and may repeat a device: several shards then
share it (the counterpart of the JAX tests' virtual CPU devices, and the
way one card holds several shards).  Without it, a CUDA layout takes
``cuda:0`` .. ``cuda:S-1`` and raises when fewer cards are visible: two
shards are never placed on one card unless the caller lists it twice.  A
CPU layout is S copies of ``cpu``.

Across processes (``parallel/multihost.py``) each rank holds one slice
of a layout, and ``make_train_mesh`` lays the trainer's (data, model)
grid over the ranks of the process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from modular_rag_system_tpu_torch.utils.device import resolve_device


def default_devices(n_shards: Optional[int], device="cuda") -> List[torch.device]:
    """``n_shards`` devices of ``device``'s type: the visible cards in
    order (all of them when ``n_shards`` is None), or copies of ``cpu``
    (one when ``n_shards`` is None)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (n_shards or 1)
    visible = torch.cuda.device_count()
    n = n_shards or visible
    if n > visible:
        raise ValueError(
            f"requested {n} shards but only {visible} CUDA devices are visible; "
            f"to place several shards on one card, pass the shards' devices "
            f"explicitly (index_devices=['cuda:0'] * {n})")
    return [torch.device("cuda", i) for i in range(n)]


def make_index_mesh(n_shards: Optional[int] = None,
                    devices: Optional[Sequence] = None,
                    device="cuda") -> List[torch.device]:
    """The devices of ``n_shards`` index shards, in shard order."""
    if devices is None:
        return default_devices(n_shards, device)
    devs = [resolve_device(d) for d in devices]
    n = n_shards or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} shards but only {len(devs)} devices")
    return devs[:n]


def make_hierarchical_index_mesh(n_slices: int, chips_per_slice: int,
                                 devices: Optional[Sequence] = None,
                                 device="cuda") -> List[List[torch.device]]:
    """(slices, chips) nested device lists; shard ``i * chips + c`` is
    chip ``c`` of slice ``i``.  The top-k merge runs within each slice,
    then only k candidates per slice go across slices."""
    need = n_slices * chips_per_slice
    if devices is not None and need > len(devices):
        raise ValueError(f"mesh {n_slices}x{chips_per_slice} > {len(devices)} devices")
    flat = make_index_mesh(need, devices, device)
    return [flat[i * chips_per_slice:(i + 1) * chips_per_slice] for i in range(n_slices)]


@dataclass
class TrainMesh:
    """This rank's place in a (data, model) grid of ranks (rank ``d *
    model + m`` holds cell (d, m)) and the groups it runs collectives
    over: ``data_group`` the ranks of its model column, ``model_group``
    those of its data row, ``group`` the whole grid (all None without a
    process group, where the grid is 1 x 1).  ``data_index`` is None on a
    rank outside the grid."""

    data: int
    model: int
    data_index: Optional[int]
    model_index: Optional[int]
    data_group: object = None
    model_group: object = None
    group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_train_mesh(data: int, model: int = 1) -> TrainMesh:
    """The (data, model) layout of the contrastive trainer over the ranks
    of the default process group (the JAX package's 2-D device mesh, one
    rank a device).  Every rank creates every subgroup, in one order, as
    ``new_group`` requires; raises when ``data * model`` exceeds the
    group's size (1 without a group)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model}: both axes must be >= 1")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} > {world} ranks")
    if not initialized:
        return TrainMesh(data, model, 0, 0)
    r = dist.get_rank()
    mine = r < data * model
    d_idx, m_idx = (r // model, r % model) if mine else (None, None)
    group = dist.new_group(list(range(data * model)))
    data_group = model_group = None
    for m in range(model):  # one data group per model column
        g = dist.new_group([d * model + m for d in range(data)])
        if mine and m == m_idx:
            data_group = g
    for d in range(data):  # one model group per data row
        g = dist.new_group([d * model + m for m in range(model)])
        if mine and d == d_idx:
            model_group = g
    return TrainMesh(data, model, d_idx, m_idx, data_group, model_group,
                     group if mine else None)
