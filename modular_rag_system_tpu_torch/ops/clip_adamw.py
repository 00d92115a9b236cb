"""Global-norm clip and AdamW over flat f32 buffers: the trainer's update.

``models/train.py`` keeps its f32 masters, first moments and second
moments each in one contiguous buffer, the tensors that the model axis
splits first and the replicated ones after element ``split``, and hands
the gradient over in the same flat order.  One call updates all of them,
as optax's ``clip_by_global_norm`` followed by ``adamw`` does:

* the global norm is sqrt(s + r), s the sum of g^2 over ``[0, split)``
  (summed over the model group by ``reduce_split`` where one is given),
  r that over ``[split, n)``;
* the gradient is scaled by ``clip / norm`` only when ``norm >= clip``
  (computed as ``g / norm * clip``);
* mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
  u = (mu / bc1) / (sqrt(nu / bc2) + eps), p = p + (u + wd p) * (-lr),
  everything in f32, each bias correction applied as a product by its f32
  reciprocal (as PyTorch divides a tensor by a scalar on the card).

On a CUDA device ``clip_adamw`` launches ``kernels/clip_adamw.cu``'s two
entry points, ``clip_adamw_norm`` (per-CTA partial sums of squares) and
``clip_adamw_apply`` (the norm from the partials, then one pass over the
elements); nothing is read back to the host.  On the CPU it runs
``clip_adamw_reference``, the same arithmetic as a handful of plain ops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from modular_rag_system_tpu_torch import kernels

# optax's adamw defaults; the kernel holds the same values as constants
B1, B2, EPS = 0.9, 0.999, 1e-8
# CTAs of both launches, and so partial sums a segment: a fixed multiple of
# the H100's 132 SMs, so the order of the sums, and their bits, never change
GRID = 4 * 132
_MAX_N = 2**31 - 1


def _f32(x: float) -> float:
    return float(np.float32(x))


# the constants as the kernel rounds them
_B1, _OMB1, _B2, _OMB2, _EPS = (_f32(x) for x in (B1, 1.0 - B1, B2, 1.0 - B2, EPS))


class AdamWScalars(NamedTuple):
    """One update's scalars as f32 values, in ``clip_adamw_apply``'s
    argument order."""

    inv_bc1: float
    inv_bc2: float
    wd: float
    step: float
    clip: float


def adamw_scalars(lr: float, count: int, weight_decay: float, clip_norm: float
                  ) -> AdamWScalars:
    """The scalars of update number ``count`` (1 for the first) at
    learning rate ``lr``."""
    bc1, bc2 = np.float32(1.0 - B1 ** count), np.float32(1.0 - B2 ** count)
    return AdamWScalars(float(np.float32(1.0) / bc1), float(np.float32(1.0) / bc2),
                        _f32(weight_decay), _f32(-lr), _f32(clip_norm))


def clip_adamw_reference(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, split: int, h: AdamWScalars,
                         reduce_split: Optional[Callable] = None) -> torch.Tensor:
    """Plain PyTorch version of ``clip_adamw``; returns the global norm."""
    s = torch.sum(g[:split] * g[:split])
    r = torch.sum(g[split:] * g[split:])
    if reduce_split is not None:
        s = reduce_split(s)
    norm = torch.sqrt(s + r)
    g = torch.where(norm < h.clip, g, g / norm * h.clip)
    mu.mul_(_B1).add_(_OMB1 * g)
    nu.mul_(_B2).add_(_OMB2 * (g * g))
    u = (mu * h.inv_bc1) / (torch.sqrt(nu * h.inv_bc2) + _EPS)
    p.add_((u + h.wd * p) * h.step)
    return norm


def clip_adamw(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
               split: int, h: AdamWScalars, reduce_split: Optional[Callable] = None
               ) -> torch.Tensor:
    """Clip ``g`` by the global norm and apply one AdamW update to ``p``,
    ``mu`` and ``nu`` in place.  All four: flat f32 buffers of one length
    on one device; ``split``: where the model-split segment ends;
    ``reduce_split``: maps this rank's 0-dim sum of squares over that
    segment to its sum over the model group (None: one rank).  Returns
    the global norm as a 0-dim tensor on the buffers' device, without
    waiting for it.

    On a CUDA device this launches the hand-written kernel's two entry
    points; on the CPU it runs the plain version."""
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n or \
                not t.is_contiguous() or t.device != p.device:
            raise ValueError(f"clip_adamw: {name} must be a contiguous flat f32 buffer of "
                             f"{n} elements on {p.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 <= split <= n:
        raise ValueError(f"clip_adamw: split {split} outside [0, {n}]")
    if p.device.type == "cpu":
        return clip_adamw_reference(p, g, mu, nu, split, h, reduce_split)
    if n > _MAX_N or any(t.data_ptr() % 16 for t in (p, g, mu, nu)):
        raise ValueError(f"clip_adamw takes 16-byte aligned buffers of at most {_MAX_N} "
                         f"elements, got {n}")
    stream = torch.cuda.current_stream(p.device).cuda_stream
    work = torch.empty(2 * GRID + 1, dtype=torch.float32, device=p.device)
    partials, norm = work[:2 * GRID], work[2 * GRID:]
    kernels.launch("clip_adamw_norm", g.data_ptr(), n, split, GRID, partials.data_ptr(),
                   stream)
    split_sum = None
    if reduce_split is not None:
        split_sum = reduce_split(partials[:GRID].sum()).reshape(1).to(p.device, torch.float32)
    kernels.launch("clip_adamw_apply", p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                   nu.data_ptr(), n, partials.data_ptr(), GRID,
                   None if split_sum is None else split_sum.data_ptr(), norm.data_ptr(),
                   *h, stream)
    return norm.reshape(())
