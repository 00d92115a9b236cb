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

Labels are -1 for rows at or past ``count``.
"""

from __future__ import annotations

import numpy as np
import torch


def _assign(rows: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by inner product, ties to the lowest id."""
    return torch.argmax(rows @ centroids.T, dim=1)


def kmeans_fit(E: torch.Tensor, count: int, init_centroids, iters: int = 10,
               batch: int = 65536):
    """Fit spherical k-means on rows [0, count) of E.

    E (cap, d) f32 or bf16 rows (L2-normalized; dead rows may be zero),
    init_centroids (C, d).  Returns (centroids (C, d) f32 L2-normalized,
    labels (cap,) int32, -1 at or past ``count``)."""
    cap, d = E.shape
    count = int(count)
    cents = torch.as_tensor(init_centroids, dtype=torch.float32).to(E.device)
    C = cents.shape[0]
    for _ in range(iters):
        sums = torch.zeros((C, d), dtype=torch.float32, device=E.device)
        counts = torch.zeros((C,), dtype=torch.float32, device=E.device)
        for s in range(0, count, batch):
            rows = E[s:min(s + batch, count)].float()
            a = _assign(rows, cents)
            sums.index_add_(0, a, rows)
            counts += torch.bincount(a, minlength=C).float()
        new = sums / torch.clamp(counts[:, None], min=1.0)
        new = new / torch.clamp(torch.linalg.vector_norm(new, dim=1, keepdim=True),
                                min=1e-12)
        cents = torch.where(counts[:, None] > 0, new, cents)
    labels = torch.full((cap,), -1, dtype=torch.int32, device=E.device)
    for s in range(0, count, batch):
        rows = E[s:min(s + batch, count)].float()
        labels[s:s + rows.shape[0]] = _assign(rows, cents).to(torch.int32)
    return cents, labels


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
