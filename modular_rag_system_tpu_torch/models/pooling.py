"""The sentence encoders' pooling: a batch's final hidden states (B, L,
hidden) and its mask (B, L) -> (B, hidden) f32 unit rows.

* ``"mean"``: the masked mean over the live tokens, in f32 (BERT, MiniLM,
  ModernBERT);
* ``"last"``: the state of the last live token (a decoder pooled as an
  embedder: e5-mistral, Qwen3-Embedding; DeepSeek-V3 here);

then L2 normalisation with a 1e-12 floor.  A row with no live token
pools to zeros.  Each module names its pooling; there is no setting."""

from __future__ import annotations

import torch


def pool(x: torch.Tensor, mask: torch.Tensor, how: str = "mean") -> torch.Tensor:
    if how == "mean":
        m = mask.float()[..., None]
        pooled = (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    elif how == "last":
        L = mask.shape[1]
        at = (mask.bool() * torch.arange(L, device=mask.device)).amax(1)
        pooled = x[torch.arange(x.shape[0], device=x.device), at].float()
        pooled = pooled * mask.bool().any(1, keepdim=True)
    else:
        raise ValueError(f"pooling must be 'mean' or 'last', got {how!r}")
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)
