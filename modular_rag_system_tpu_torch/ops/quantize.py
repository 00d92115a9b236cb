"""Per-row symmetric int8 quantization of the device index."""

from __future__ import annotations

import torch

# f32 reciprocal of 127 (see quantize_rows)
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_rows(x: torch.Tensor):
    """(N, d) -> ((N, d) int8, (N, 1) f32 scales).

    Symmetric absmax in f32 whatever the store dtype: q = round(x / scale)
    (half to even), scale = absmax / 127.  Zero rows get scale 0, so
    they dequantize to exactly 0 and deleted rows stay dead.

    XLA compiles the division by the constant 127 as a multiply by its
    f32 reciprocal; the port does the same, so scales match the JAX
    package bit for bit.  The division by ``safe`` stays a division."""
    x = x.float()
    scale = x.abs().amax(dim=1, keepdim=True) * INV_127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, scale
