"""Vocab-chunked cross-entropy for the DALLE head.

Counterpart of the JAX package's `ops/losses.py`: the split text/image
cross-entropy computed over the vocabulary in chunks, so the [B, N, V]
logits never exist at once; each chunk's body is recomputed in the
backward pass (`torch.utils.checkpoint`, the reference's
`jax.checkpoint`) instead of saving its logits. Same per-position vocab
blocking as the dense path (text rows emit text ids only, image rows
image ids only; blocked entries add nothing to the logsumexp). Plain
PyTorch: the reference has no kernel here either.

Under autocast the chunk products run in bfloat16 and their logits are
rounded to it; the reference accumulates them in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def _chunk(h, kc, bc, labels, m, s, g, base: int, row_is_text, num_text_vocab: int):
    """Fold one vocab chunk [base, base + width) into the streaming
    logsumexp (m, s) and the gathered gold logit g."""
    width = kc.shape[1]
    logits = torch.matmul(h, kc.to(h.dtype)).float()
    if bc is not None:
        logits = logits + bc.float()
    ids = base + torch.arange(width, device=h.device)
    allowed = row_is_text[None, :, None] == (ids < num_text_vocab)[None, None, :]
    logits = torch.where(allowed, logits, NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(dim=-1)
    in_chunk = (labels >= base) & (labels < base + width)
    local = (labels - base).clamp(0, width - 1)
    gold = logits.gather(-1, local[..., None])[..., 0]
    return m_new, s, torch.where(in_chunk, gold, g)


def chunked_masked_ce(
    h: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    labels: torch.Tensor,
    *,
    row_is_text: torch.Tensor,
    num_text_vocab: int,
    chunk: int = 2048,
) -> torch.Tensor:
    """Per-position CE of softmax(h @ kernel + bias) against `labels`.

    h [B, N, D]; kernel [D, V]; bias [V] or None; labels [B, N] ids;
    row_is_text [N] bool: True rows may emit only ids < num_text_vocab,
    False rows only ids >= num_text_vocab. Returns [B, N] float32.
    """
    b, n, _ = h.shape
    v = kernel.shape[1]
    chunk = min(chunk, max(128, -(-v // 128) * 128))
    labels = labels.long()
    m = torch.full((b, n), NEG, dtype=torch.float32, device=h.device)
    s = torch.zeros((b, n), dtype=torch.float32, device=h.device)
    g = torch.zeros((b, n), dtype=torch.float32, device=h.device)
    for base in range(0, v, chunk):
        kc = kernel[:, base : base + chunk]
        bc = None if bias is None else bias[base : base + chunk]
        args = (h, kc, bc, labels, m, s, g, base, row_is_text, num_text_vocab)
        if torch.is_grad_enabled():
            m, s, g = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            m, s, g = _chunk(*args)
    return m + torch.log(s) - g


def split_weighted_mean(
    per_pos: torch.Tensor,
    split: int,
    first_weight: float,
    second_weight: float,
    drop_last_of_first: bool = False,
) -> torch.Tensor:
    """(w1 * mean(first part) + w2 * mean(second part)) / (w1 + w2);
    `drop_last_of_first` leaves out the first part's final position (the
    inverse objective's image segment)."""
    first = per_pos[:, : split - 1] if drop_last_of_first else per_pos[:, :split]
    second = per_pos[:, split:]
    return (first_weight * first.mean() + second_weight * second.mean()) / (
        first_weight + second_weight
    )
