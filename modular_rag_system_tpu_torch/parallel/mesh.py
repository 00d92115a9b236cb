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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

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
