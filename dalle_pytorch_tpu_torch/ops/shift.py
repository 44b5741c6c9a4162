"""Token shift for the joint text+image sequence.

Counterpart of the JAX package's `ops/shift.py`. Before attention and
feed-forward, part of each token's channels come from an earlier token:
text positions take their first half from the token to the left; image
positions (an H x W grid) take their first quarter from one row up and
their second quarter from one column left.

Cached decode keeps a ring of the last `image_fmap_size` pre-shift token
vectors, indexed by position mod fmap: the slot about to be overwritten
at position p holds h[p - fmap] (one grid row up) and slot (p-1) mod fmap
holds h[p-1]. Here the decode position is a Python int (the micro-batch
decode runs every row in lockstep), so branches on it are host-side, and
`shift_token_step` updates the ring in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_tokens_dalle(x: torch.Tensor, text_len: int, image_fmap_size: int) -> torch.Tensor:
    """Apply DALL-E token shift to x [B, N, D]; text_len counts <bos>."""
    b, n, d = x.shape
    if d % 4:
        raise ValueError(f"model dim {d} must be divisible by 4 for token shift")
    img_seq_len = image_fmap_size * image_fmap_size
    half, q = d // 2, d // 4

    if n < text_len:  # no image tokens present
        x_shift = F.pad(x[:, :-1, :half], (0, 0, 1, 0))
        return torch.cat([x_shift, x[..., half:]], dim=-1)

    x_text, x_img = x[:, :text_len], x[:, text_len:]
    t_shift = F.pad(x_text[:, :-1, :half], (0, 0, 1, 0))
    x_text = torch.cat([t_shift, x_text[..., half:]], dim=-1)

    img_len = x_img.shape[1]
    if img_len == 0:
        return x_text
    x_img = F.pad(x_img, (0, 0, 0, img_seq_len - img_len))
    x_img = x_img.reshape(b, image_fmap_size, image_fmap_size, d)
    top = F.pad(x_img[:, :-1, :, :q], (0, 0, 0, 0, 1, 0))
    left = F.pad(x_img[:, :, :-1, q : 2 * q], (0, 0, 1, 0))
    x_img = torch.cat([top, left, x_img[..., 2 * q :]], dim=-1)
    x_img = x_img.reshape(b, img_seq_len, d)[:, :img_len]
    return torch.cat([x_text, x_img], dim=1)


def shift_ring_from_prefill(h: torch.Tensor, fmap: int) -> torch.Tensor:
    """Ring after prefilling positions 0..n-1 with pre-shift values h."""
    b, n, d = h.shape
    ring = h.new_zeros((b, fmap, d))
    start = max(0, n - fmap)
    slots = torch.arange(start, n, device=h.device) % fmap
    ring[:, slots] = h[:, start:]
    return ring


def shift_token_step(
    h: torch.Tensor, ring: torch.Tensor, pos: int, text_len: int, fmap: int
):
    """One-token shift at global position `pos` against the ring.

    h: [B, 1, D] pre-shift value of the token at `pos`. Returns
    (shifted [B, 1, D], ring); the ring is updated in place (slot
    pos mod fmap now holds h), which saves a copy of it per layer-step.
    """
    d = h.shape[-1]
    half, q = d // 2, d // 4
    cur = h[:, 0]
    prev = ring[:, (pos - 1) % fmap]
    if pos < text_len:
        first = prev[:, :half] if pos > 0 else torch.zeros_like(prev[:, :half])
        out = torch.cat([first, cur[:, half:]], dim=-1)
    else:
        # image position i = pos - text_len at (row i // fmap, col i % fmap);
        # both sources are image positions whenever valid
        i = pos - text_len
        up = ring[:, pos % fmap]
        top = up[:, :q] if i >= fmap else torch.zeros_like(up[:, :q])
        left = prev[:, q : 2 * q] if i % fmap else torch.zeros_like(prev[:, q : 2 * q])
        out = torch.cat([top, left, cur[:, 2 * q :]], dim=-1)
    ring[:, pos % fmap] = cur  # after the reads above: `up` aliases this slot
    return out[:, None], ring
