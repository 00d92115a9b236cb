"""Per-row symmetric int8 quantization of the device index, and the int4
row-pair packing of the ivf fine copy."""

from __future__ import annotations

import torch

# f32 reciprocals of 127 and 7 (see quantize_rows, int4_scale_and_values)
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
INV_7 = float(torch.tensor(1.0 / 7.0, dtype=torch.float32))


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


def int4_scale_and_values(x: torch.Tensor):
    """(N, d) f32 -> ((N, d) int32 values in [-7, 7], (N, 1) f32 scales):
    symmetric absmax, scale = absmax / 7, zero rows get scale 0.

    As with 127, the compiled JAX code multiplies by the f32 reciprocal of
    7 (in ``quantize_int4_blocks`` and in the row-update scatter alike),
    and the port does the same so scales match bit for bit."""
    x = x.float()
    scale = x.abs().amax(dim=1, keepdim=True) * INV_7
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -7, 7).to(torch.int32)
    return q, scale


def quantize_int4_blocks(rows: torch.Tensor, nb: int, slab: int):
    """(nb * slab, d) f32 -> ((nb, slab // 2, d) int8 packed, (nb, slab)
    f32 scales).  Byte (b, r, j) holds row r's value j in the high nibble
    and row r + slab // 2's in the low nibble; scales stay per logical
    row.  ``slab`` must be even."""
    q, scale = int4_scale_and_values(rows)
    q3 = q.view(nb, slab, -1)
    hi, lo = q3[:, : slab // 2], q3[:, slab // 2:]
    # hi << 4 is in [-112, 112]; or-ing the low nibble keeps it in int8 range
    packed = ((hi << 4) | (lo & 0xF)).to(torch.int8)
    return packed, scale.view(nb, slab)


def unpack_int4_values(packed: torch.Tensor) -> torch.Tensor:
    """(..., slab // 2, d) packed bytes -> (..., slab, d) int32 values in
    [-8, 7]: the high nibbles' rows first (an arithmetic shift), then the
    low nibbles' (sign-extended)."""
    t = packed.to(torch.int32)
    return torch.cat([t >> 4, ((t & 0xF) ^ 8) - 8], dim=-2)


def unpack_int4_blocks(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_int4_blocks`` -> (nb, slab, d) f32."""
    return unpack_int4_values(packed).float() * scales[..., None]
