"""Memory-efficient (flash-style) self-attention of the encoder.

The port of the JAX package's ``ops/flash_attention.py``: the attention
of ``embedding.attention_impl="flash"``, which lets a long-context
encoder embed a whole document as one sequence without the dense path's
(B, H, L, L) score tensor in device memory.

``mea_attention(q, k, v, pad_mask)`` computes softmax(q k^T / sqrt(dh)) v
with key padding for (B, L, H, dh) tensors in the model dtype.  Its
arithmetic is the TPU kernel's, not the dense path's: the scores are f32
sums times the scale (the query is not pre-scaled), only KEYS are masked,
at a finite -1e9 (a batch row that is all padding softmaxes uniformly and
stays finite, where -inf would give NaN and poison the mean pool), the
softmax runs in f32, exp(s - m) is rounded to the model dtype before it
multiplies v, that product accumulates in f32, and the f32 row sum,
floored at 1e-30, divides at the end.  The JAX kernel pads L to Lp
(``padded_length``) with keys that score -1e9 and carry zero rows of v,
so a row whose keys are all padding sums exp(0) = 1 over all Lp keys but
only the first L add to P.V: its output is sum(v[:L]) / Lp.  Both
versions here add Lp - L to the row sum of such a row (its maximum is
the masked -1e9), which gives the same value; the pooling mask drops
such rows either way.

``window=w`` is the sliding-window mode (ModernBERT's local layers): query
i sees only the keys j with |i - j| <= w.  A key outside the band is no
key of the row (it adds nothing to its maximum or its sum), a padded key
inside it scores -1e9 as above, and a row whose band holds no live key
(its maximum is -1e9) is all zeros: the TPU padding rule is a rule of the
full mode only.  The kernel's window mode is its own entry point,
``mea_attention_window``, and loads only the key tiles that meet a query
tile's band.

On a CUDA device the wrapper launches ``kernels/mea_attention.cu``; on
the CPU it runs the plain version.  The full mode has two designs on the
card, with the same arithmetic: a tile template for every shape, and a
Hopper design (wgmma tiles, a TMA ring, the key bounds once a launch)
for bf16 at dh 64 from ``LONG_FROM`` keys on; ``full_design`` picks it.
"""

from __future__ import annotations

from typing import Optional

import torch

from modular_rag_system_tpu_torch import kernels
from modular_rag_system_tpu_torch.utils.profiling import TRACER

_NEG = -1e9  # the finite masked score (not -inf: see the module docstring)
# f32 bytes of one chunk of the plain version's (c, H, L, L) scores
_REF_CHUNK_BYTES = 1 << 30
_MAX_DH = 128
# query rows a block of the window mode's plain version
_WINDOW_QB = 256
# the full mode's Hopper design from this L on (bf16, dh 64): where it
# overtakes the tile template on an H100 (PERF.md, kernel table row 7)
LONG_FROM = 512
_LONG_DH = 64
# its key tile, and the floats of its per-(batch row x head, key tile)
# record of key bounds: a code a key and four of the tile's
_LONG_KEYS = 128
_LONG_RECORD = _LONG_KEYS + 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_length(L: int) -> int:
    """The key length the JAX kernel pads L to: L up to 128, then up to
    its query block, min(512, that)."""
    lp = _round_up(L, 128)
    return _round_up(lp, min(512, lp))


def _window_reference(q, k, v, pad_mask, window: int):
    """The window mode's plain version, _WINDOW_QB query rows at a time
    against the keys of their band."""
    B, L, H, dh = q.shape
    scale = 1.0 / (dh ** 0.5)
    out = torch.empty_like(q)
    live = pad_mask.to(torch.float32) > 0.5
    pos = torch.arange(L, device=q.device)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))  # (B, H, L, dh)
    for q0 in range(0, L, _WINDOW_QB):
        q1 = min(q0 + _WINDOW_QB, L)
        k0, k1 = max(q0 - window, 0), min(q1 + window, L)
        s = (qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(2, 3)) * scale
        s = torch.where(live[:, None, None, k0:k1], s, _NEG)
        band = (pos[q0:q1, None] - pos[None, k0:k1]).abs() <= window
        s = torch.where(band, s, float("-inf"))
        m = s.amax(dim=3, keepdim=True)
        e = torch.exp(s - m)
        o = e.to(v.dtype).float() @ vf[:, :, k0:k1]
        o = o / torch.clamp(e.sum(dim=3, keepdim=True), min=1e-30)
        o = torch.where(m == _NEG, 0.0, o)  # no live key in the band
        out[:, q0:q1] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def mea_attention_reference(q, k, v, pad_mask, window: Optional[int] = None):
    """Plain PyTorch version of ``mea_attention``, a few batch rows at a
    time so the (c, H, L, L) f32 scores stay bounded (the window mode: a
    block of query rows at a time)."""
    if window is not None:
        return _window_reference(q, k, v, pad_mask, window)
    B, L, H, dh = q.shape
    scale = 1.0 / (dh ** 0.5)
    extra = float(padded_length(L) - L)
    out = torch.empty_like(q)
    live = pad_mask.to(torch.float32) > 0.5
    step = max(_REF_CHUNK_BYTES // max(H * L * L * 4, 1), 1)
    for s0 in range(0, B, step):
        sl = slice(s0, s0 + step)
        qf, kf, vf = (x[sl].float().permute(0, 2, 1, 3) for x in (q, k, v))  # (c, H, L, dh)
        s = (qf @ kf.transpose(2, 3)) * scale
        s = torch.where(live[sl, None, None, :], s, _NEG)
        m = s.amax(dim=3, keepdim=True)
        e = torch.exp(s - m)
        # the JAX kernel's padded keys: exp(0) = 1 each in an all-padding row
        denom = e.sum(dim=3, keepdim=True) + torch.where(m == _NEG, extra, 0.0)
        o = e.to(v.dtype).float() @ vf
        out[sl] = (o / torch.clamp(denom, min=1e-30)).permute(0, 2, 1, 3).to(q.dtype)
    return out


def full_design(L: int, dh: int, dtype: torch.dtype) -> int:
    """The full mode's kernel design for a launch: 1 (the Hopper design)
    for bf16 at dh 64 from ``LONG_FROM`` keys on, else 0 (the tile
    template)."""
    return int(dtype == torch.bfloat16 and dh == _LONG_DH and L >= LONG_FROM)


def mea_attention(q, k, v, pad_mask, window: Optional[int] = None):
    """softmax(q k^T / sqrt(dh)) v with key padding, no (L, L) tensor in
    device memory.  ``q``/``k``/``v``: (B, L, H, dh) bf16 or f32;
    ``pad_mask``: (B, L), 1 = live; ``window``: None (every key) or the
    band's half width w >= 0 (keys with |i - j| <= w).  Returns (B, L, H,
    dh) in q's dtype.

    On a CUDA device this launches the hand-written kernel; on the CPU
    it runs the plain version."""
    if window is not None and (int(window) != window or window < 0):
        raise ValueError(f"mea_attention: window must be a whole number >= 0, got {window!r}")
    if q.device.type == "cpu":
        return mea_attention_reference(q, k, v, pad_mask, window)
    B, L, H, dh = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mea_attention takes bf16 or f32 tensors, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("mea_attention: q, k and v must share one shape and dtype")
    if dh % 8 or dh > _MAX_DH or B * H > 65535 or tuple(pad_mask.shape) != (B, L):
        raise ValueError(f"mea_attention needs dh % 8 == 0, dh <= {_MAX_DH}, B * H <= "
                         f"65535 and a (B, L) mask; got q {tuple(q.shape)}, mask "
                         f"{tuple(pad_mask.shape)}")
    if window is None:
        return _launch(q, k, v, pad_mask, full_design(L, dh, q.dtype))
    return _launch(q, k, v, pad_mask, None, min(int(window), L))


def _launch(q, k, v, pad_mask, design: Optional[int], window: int = 0):
    """One launch of the full mode's ``design`` (None: the window mode's
    entry with ``window``) on checked CUDA tensors."""
    B, L, H, dh = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pad = pad_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or L == 0:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            int(q.dtype == torch.bfloat16), B, L, H, dh, 1.0 / (dh ** 0.5))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if design is None:
        kernels.launch("mea_attention_window", *args, window, out.data_ptr(), stream)
        return out
    work = None
    if design:
        work = torch.empty(B * H * -(-L // _LONG_KEYS) * _LONG_RECORD, dtype=torch.float32,
                           device=q.device)
        TRACER.count("attn.full_long_launches")
    kernels.launch("mea_attention", *args, design, 0 if work is None else work.data_ptr(),
                   out.data_ptr(), stream)
    return out
