"""Spherical k-means (Lloyd's) for the ivf index build, in plain PyTorch.

The JAX package's ``ops/kmeans.py`` has no TPU kernel: its k-means is
batched linear algebra left to XLA.  Here the same steps run as PyTorch
tensor ops on the index's device:

* assignment: ``argmax(batch @ centroids.T)`` in true f32 (TF32 is off
  on the card, ``utils/device.py``), ties to the lowest cluster id;
* update: per-cluster sums of the assigned rows (``index_add_``) over
  row batches, then centroids re-normalized;
* rows at or past ``count`` are masked (they count nowhere; deleted,
  zeroed rows inside the live prefix count, as in the JAX package), and
  an empty cluster keeps its previous centroid.

Labels are -1 for rows at or past ``count``.  ``kmeans_fit_sharded``
runs the same steps over the shards of a sharded index, each shard's
partial sums on its own device, added in shard order on one device.
"""

from __future__ import annotations

import numpy as np
import torch


def _assign(rows: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by inner product, ties to the lowest id."""
    return torch.argmax(rows @ centroids.T, dim=1)


def _partials(E: torch.Tensor, count: int, cents: torch.Tensor, batch: int):
    """Per-cluster sums (C, d) and counts (C,) of rows [0, count) of E,
    each row assigned to its nearest centroid."""
    C, d = cents.shape
    sums = torch.zeros((C, d), dtype=torch.float32, device=E.device)
    counts = torch.zeros((C,), dtype=torch.float32, device=E.device)
    for s in range(0, count, batch):
        rows = E[s:min(s + batch, count)].float()
        a = _assign(rows, cents)
        sums.index_add_(0, a, rows)
        counts += torch.bincount(a, minlength=C).float()
    return sums, counts


def _update(sums, counts, cents):
    """The Lloyd step: normalized means; an empty cluster keeps its centroid."""
    new = sums / torch.clamp(counts[:, None], min=1.0)
    new = new / torch.clamp(torch.linalg.vector_norm(new, dim=1, keepdim=True),
                            min=1e-12)
    return torch.where(counts[:, None] > 0, new, cents)


def _labels(E: torch.Tensor, count: int, cents: torch.Tensor, batch: int):
    labels = torch.full((E.shape[0],), -1, dtype=torch.int32, device=E.device)
    for s in range(0, count, batch):
        rows = E[s:min(s + batch, count)].float()
        labels[s:s + rows.shape[0]] = _assign(rows, cents).to(torch.int32)
    return labels


def kmeans_fit(E: torch.Tensor, count: int, init_centroids, iters: int = 10,
               batch: int = 65536):
    """Fit spherical k-means on rows [0, count) of E.

    E (cap, d) f32 or bf16 rows (L2-normalized; dead rows may be zero),
    init_centroids (C, d).  Returns (centroids (C, d) f32 L2-normalized,
    labels (cap,) int32, -1 at or past ``count``)."""
    count = int(count)
    cents = torch.as_tensor(init_centroids, dtype=torch.float32).to(E.device)
    for _ in range(iters):
        cents = _update(*_partials(E, count, cents, batch), cents)
    return cents, _labels(E, count, cents, batch)


def kmeans_fit_sharded(E_shards, count: int, init_centroids, iters: int = 10,
                       batch: int = 65536, device=None):
    """Spherical k-means over rows strided across shards: shard ``s`` of
    S holds global row ``j * S + s`` at local row ``j``, so its live rows
    are its first ``max(0, ceil((count - s) / S))``.

    Each shard computes its partial cluster sums and counts over its own
    live rows on its own device; only the (C, d) partials are copied to
    ``device`` (default: the first shard's), where they are added in
    shard order, so the result does not depend on timing (the JAX
    package's ``psum``).  Returns (centroids (C, d) f32 on ``device``,
    per-shard labels (cap_s,) int32 on each shard's device, -1 past its
    live rows)."""
    S = len(E_shards)
    lead = torch.device(device) if device is not None else E_shards[0].device
    counts_s = [max(0, (int(count) - s + S - 1) // S) for s in range(S)]
    cents = torch.as_tensor(init_centroids, dtype=torch.float32).to(lead)
    for _ in range(iters):
        sums = torch.zeros_like(cents)
        counts = torch.zeros((cents.shape[0],), dtype=torch.float32, device=lead)
        for E_s, n in zip(E_shards, counts_s):
            ps, pc = _partials(E_s, n, cents.to(E_s.device), batch)
            sums += ps.to(lead)
            counts += pc.to(lead)
        cents = _update(sums, counts, cents)
    return cents, [_labels(E_s, n, cents.to(E_s.device), batch)
                   for E_s, n in zip(E_shards, counts_s)]


def init_centroids_from_rows(E: np.ndarray, count: int, n_clusters: int) -> np.ndarray:
    """Evenly spaced live rows as initial centroids (host side), with the
    JAX package's seeded jitter so duplicate rows do not collapse
    clusters."""
    idx = np.linspace(0, max(count - 1, 0), n_clusters).astype(np.int64)
    init = np.array(E[idx], dtype=np.float32)
    rng = np.random.default_rng(0)
    init = init + rng.standard_normal(init.shape).astype(np.float32) * 1e-4
    norms = np.linalg.norm(init, axis=1, keepdims=True)
    return init / np.maximum(norms, 1e-12)
