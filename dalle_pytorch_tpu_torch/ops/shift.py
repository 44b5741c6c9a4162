"""Token shift for the joint text+image sequence.

Counterpart of the JAX package's `ops/shift.py`. Before attention and
feed-forward, part of each token's channels come from an earlier token:
text positions take their first half from the token to the left; image
positions (an H x W grid) take their first quarter from one row up and
their second quarter from one column left.

Cached decode keeps a ring of the last `image_fmap_size` pre-shift token
vectors, indexed by position mod fmap: the slot about to be overwritten
at position p holds h[p - fmap] (one grid row up) and slot (p-1) mod fmap
holds h[p-1]. The decode position is a Python int (the micro-batch
decode runs every row in lockstep; branches on it are host-side) or a [B]
tensor (the continuous engine's slots, each row reading and writing its
own ring slots; branches become selects). `shift_token_step` updates the
ring in place. `shift_ring_from_prefill_at` rebuilds each row's ring at
its own resume position from one forward over a padded prefix.
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


def shift_ring_from_prefill_at(h: torch.Tensor, fmap: int, end: torch.Tensor) -> torch.Tensor:
    """Ring as if only positions 0..end[b]-1 of h [B, n, D] had been
    prefilled, each row at its own `end` ([B] tensor): slot j holds h at
    the largest position p < end[b] with p = j (mod fmap), zeros where
    that p is negative. The decode resume runs one forward over the whole
    padded prefix and rebuilds each row's ring at its resume position;
    with end == n this equals `shift_ring_from_prefill`."""
    n = h.shape[1]
    slots = torch.arange(fmap, device=h.device)[None, :]
    last = end.to(device=h.device, dtype=torch.long)[:, None] - 1
    p = last - torch.remainder(last - slots, fmap)  # [B, fmap], p = slot (mod fmap)
    vals = torch.gather(h, 1, p.clamp(0, n - 1)[..., None].expand(-1, -1, h.shape[-1]))
    return torch.where((p >= 0)[..., None], vals, torch.zeros_like(vals))


def shift_token_step(
    h: torch.Tensor, ring: torch.Tensor, pos: int, text_len: int, fmap: int
):
    """One-token shift at global position `pos` against the ring.

    h: [B, 1, D] pre-shift value of the token at `pos`, a Python int or a
    [B] tensor of per-row positions. Returns (shifted [B, 1, D], ring); the
    ring is updated in place (slot pos mod fmap now holds h), which saves a
    copy of it per layer-step.
    """
    if torch.is_tensor(pos):
        return _shift_token_step_per_row(h, ring, pos, text_len, fmap)
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


def _shift_token_step_per_row(h, ring, pos, text_len: int, fmap: int):
    """`shift_token_step` with each row at its own position pos[b]."""
    d = h.shape[-1]
    half, q = d // 2, d // 4
    cur = h[:, 0]
    rows = torch.arange(h.shape[0], device=h.device)
    pos = pos.to(torch.long)
    prev = ring[rows, (pos - 1) % fmap]
    up = ring[rows, pos % fmap]
    posb = pos[:, None]
    first = torch.where(posb > 0, prev[:, :half], torch.zeros_like(prev[:, :half]))
    text_shift = torch.cat([first, cur[:, half:]], dim=-1)
    i = posb - text_len
    top = torch.where(i >= fmap, up[:, :q], torch.zeros_like(up[:, :q]))
    left = torch.where(
        i % fmap != 0, prev[:, q : 2 * q], torch.zeros_like(prev[:, q : 2 * q])
    )
    img_shift = torch.cat([top, left, cur[:, 2 * q :]], dim=-1)
    out = torch.where(posb < text_len, text_shift, img_shift)
    ring[rows, pos % fmap] = cur  # after the reads above: `up` was copied out
    return out[:, None], ring
