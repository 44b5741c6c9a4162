"""Dense attention core: scaled dot-product attention with a boolean mask.

Counterpart of the JAX package's `ops/attention_core.py`. Scores are
accumulated in float32 whatever the input dtype; masked scores take the
finite value -finfo(float32).max, as in the reference, so a row's
softmax stays defined. The cached path uses this for pattern-masked
layers and for caches below the flash-decode threshold.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -float(torch.finfo(torch.float32).max)


def stable_softmax(t: torch.Tensor, dim: int = -1, alpha: float = 32.0**2) -> torch.Tensor:
    """Half-precision-stable softmax: pre-divide by alpha before the
    max-subtract (detached, as the reference's stop_gradient), then scale
    back."""
    t = t / alpha
    t = t - t.amax(dim=dim, keepdim=True).detach()
    return torch.softmax(t * alpha, dim=dim)


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stable: bool = False,
) -> torch.Tensor:
    """q, k, v: [..., n, d]; mask broadcastable to [..., n_q, n_k], True =
    attend. Returns [..., n_q, d] in v's dtype."""
    scale = q.shape[-1] ** -0.5
    # float32 scores under autocast too (it would recast the product to
    # bf16, where NEG_INF overflows)
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        if mask is not None:
            scores = torch.where(mask, scores, NEG_INF)
        attn = stable_softmax(scores) if stable else torch.softmax(scores, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)
