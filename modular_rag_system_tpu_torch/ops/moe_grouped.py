"""The SwiGLU GEMMs of the DeepSeek-V3 expert layer over groups of rows.

``models/deepseek_v3.py`` sorts its (token, expert) pairs by expert, so
that each expert's rows lie together; ``offsets`` (E + 1 int32, the
exclusive prefix sums of the experts' row counts) say where.  Two
functions run every group's SwiGLU in one call each:

* ``gate_up(x, w13, offsets)``: act = silu(g) * u, g and u the products
  of each group's rows with the gate and the up rows of its ``w13``
  (E, 2 D, K), each rounded to x's dtype, the SwiGLU in f32, rounded once;
* ``down(act, w2, offsets, dest)``: each group's act rows times its
  ``w2`` (E, H, D) transposed, rounded once, row r stored at row dest[r]
  of the (P, H) output (``dest`` None: at row r).

``offsets`` None is one group of every row (a dense SwiGLU: ``w13`` (2 D,
K), ``w2`` (H, D)).  Products of the dtype's values sum in f32.

On a CUDA device both launch ``kernels/moe_grouped.cu`` (entries
``moe_gate_up`` and ``moe_down``) with the offsets on the card: nothing is
read back to the host.  On the CPU they run the plain versions, which loop
over ``offsets.tolist()``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from modular_rag_system_tpu_torch import kernels

# the kernel's tiles: depth 64, 128 act columns, 256 output columns
_K_STEP, _D_STEP, _H_STEP = 64, 128, 256
_MAX_GROUPS = 256


def _groups(offsets: Optional[torch.Tensor], P: int):
    """[(group, first row, end row)] of the plain versions."""
    if offsets is None:
        return [(None, 0, P)]
    at = offsets.tolist()
    return [(e, a, b) for e, (a, b) in enumerate(zip(at[:-1], at[1:])) if b > a]


def gate_up_reference(x: torch.Tensor, w13: torch.Tensor,
                      offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``gate_up``."""
    act = x.new_empty((x.shape[0], w13.shape[-2] // 2))
    for e, a, b in _groups(offsets, x.shape[0]):
        g, u = F.linear(x[a:b], w13 if e is None else w13[e]).chunk(2, dim=-1)
        act[a:b] = (F.silu(g.float()) * u.float()).to(x.dtype)
    return act


def down_reference(act: torch.Tensor, w2: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                   dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``down``."""
    ys = act.new_empty((act.shape[0], w2.shape[-2]))
    for e, a, b in _groups(offsets, act.shape[0]):
        torch.mm(act[a:b], (w2 if e is None else w2[e]).t(), out=ys[a:b])
    if dest is None:
        return ys
    out = torch.empty_like(ys)
    out[dest] = ys
    return out


def _check(name: str, x: torch.Tensor, w: torch.Tensor, offsets, K: int, N: int, step: int):
    groups = 1 if offsets is None else offsets.numel() - 1
    want_w = (N, K) if offsets is None else (groups, N, K)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 rows and weights on the card, got {x.dtype} "
                         f"and {w.dtype}")
    if x.dim() != 2 or x.shape[1] != K or tuple(w.shape) != want_w:
        raise ValueError(f"{name}: rows (P, {K}) and weights {want_w}, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if K % _K_STEP or N % step or not 1 <= groups <= _MAX_GROUPS or x.shape[0] >= 2**31:
        raise ValueError(f"{name} needs a depth % {_K_STEP} == 0, widths % {step} == 0, 1 to "
                         f"{_MAX_GROUPS} groups and under 2^31 rows; got depth {K}, width "
                         f"{N}, {groups} groups, {x.shape[0]} rows")
    if offsets is not None and (offsets.dtype != torch.int32 or offsets.dim() != 1
                                or offsets.device != x.device):
        raise ValueError(f"{name}: offsets must be a flat int32 tensor on {x.device}")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != x.device:
            raise ValueError(f"{name}: rows and weights must be contiguous, 16-byte aligned "
                             f"and on one device")


def gate_up(x: torch.Tensor, w13: torch.Tensor,
            offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, K) rows, (E, 2 D, K) gate and up weights (or (2 D, K) with
    ``offsets`` None) -> (P, D) SwiGLU activations in x's dtype.

    On a CUDA device this launches the hand-written kernel; on the CPU it
    runs the plain version."""
    w13 = w13.to(x.dtype)
    if x.device.type == "cpu":
        return gate_up_reference(x, w13, offsets)
    P, K = x.shape
    N = w13.shape[-2]
    _check("gate_up", x, w13, offsets, K, N, 2 * _D_STEP)
    act = torch.empty((P, N // 2), dtype=x.dtype, device=x.device)
    if P:
        kernels.launch("moe_gate_up", x.data_ptr(), w13.data_ptr(),
                       None if offsets is None else offsets.data_ptr(), P,
                       1 if offsets is None else offsets.numel() - 1, K, N // 2,
                       act.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    return act


def down(act: torch.Tensor, w2: torch.Tensor, offsets: Optional[torch.Tensor] = None,
         dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, D) activations, (E, H, D) down weights (or (H, D) with
    ``offsets`` None) -> (P, H) in act's dtype: row r's product at row
    dest[r] (``dest`` a permutation of range(P), int64), or at row r.

    On a CUDA device this launches the hand-written kernel; on the CPU it
    runs the plain version."""
    w2 = w2.to(act.dtype)
    if act.device.type == "cpu":
        return down_reference(act, w2, offsets, dest)
    P, D = act.shape
    H = w2.shape[-2]
    _check("down", act, w2, offsets, D, H, _H_STEP)
    if dest is not None and (dest.dtype != torch.int64 or tuple(dest.shape) != (P,)
                             or not dest.is_contiguous() or dest.device != act.device):
        raise ValueError(f"down: dest must be a contiguous ({P},) int64 tensor on {act.device}")
    out = torch.empty((P, H), dtype=act.dtype, device=act.device)
    if P:
        kernels.launch("moe_down", act.data_ptr(), w2.data_ptr(),
                       None if offsets is None else offsets.data_ptr(),
                       None if dest is None else dest.data_ptr(), P,
                       1 if offsets is None else offsets.numel() - 1, D, H, out.data_ptr(),
                       torch.cuda.current_stream(act.device).cuda_stream)
    return out
