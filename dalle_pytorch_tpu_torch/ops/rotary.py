"""Rotary position embeddings for the joint text+image sequence.

Counterpart of the JAX package's `ops/rotary.py`: three rotary blocks per
head (1-D language rotary over text positions with images pinned to the
sentinel 8192; 2-D axial pixel rotary over the feature-map grid with text
pinned to the off-grid coordinate -10), rot_dim = dim_head // 3 each,
interleaved pairs (adjacent even/odd channels rotate together).

The angle table is built host-side in float64 numpy and stored as
float32, exactly as the reference does. `apply_rotary` casts the table to
the tensor's dtype BEFORE cos/sin, so in bf16 the angles are rounded
first — the reference's order, kept on purpose.
"""

from __future__ import annotations

import numpy as np
import torch


def rotary_freqs_lang(rot_dim: int, theta: float = 10000.0) -> np.ndarray:
    """Inverse-frequency vector for ordinary (language) rotary embeddings."""
    return 1.0 / (theta ** (np.arange(0, rot_dim, 2)[: rot_dim // 2] / rot_dim))


def rotary_freqs_pixel(rot_dim: int, max_freq: float = 10.0) -> np.ndarray:
    """Frequency vector for 'pixel' rotary embeddings (coords in [-1, 1])."""
    return np.linspace(1.0, max_freq / 2.0, rot_dim // 2) * np.pi


def _angles(positions: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """Outer product position x freq, each angle repeated for its pair."""
    ang = np.einsum("...,f->...f", positions.astype(np.float64), freqs)
    return np.repeat(ang, 2, axis=-1)


def build_dalle_rotary(
    text_len: int,
    image_fmap_size: int,
    dim_head: int,
    theta: float = 10000.0,
    max_freq: float = 10.0,
    text_sentinel: float = 8192.0,
    pixel_sentinel: float = -10.0,
) -> torch.Tensor:
    """Combined [text_len + fmap**2, 3 * 2*(rot_dim//2)] float32 angle
    table on the default device. Rows: text (with <bos>) then image in
    raster order. Channels: [text-1D | image-row | image-col]."""
    rot_dim = dim_head // 3
    img_seq_len = image_fmap_size * image_fmap_size

    lang = rotary_freqs_lang(rot_dim, theta)
    pixel = rotary_freqs_pixel(rot_dim, max_freq)

    text_block = np.concatenate(
        [
            _angles(np.arange(text_len), lang),
            _angles(np.full((img_seq_len,), text_sentinel), lang),
        ],
        axis=0,
    )

    coords = np.linspace(-1.0, 1.0, image_fmap_size)
    ax = _angles(coords, pixel)  # [fmap, d]
    row = np.broadcast_to(ax[:, None, :], (image_fmap_size, image_fmap_size, ax.shape[-1]))
    col = np.broadcast_to(ax[None, :, :], (image_fmap_size, image_fmap_size, ax.shape[-1]))
    img_axial = np.concatenate([row, col], axis=-1).reshape(img_seq_len, -1)

    text_sent = _angles(np.full((text_len,), pixel_sentinel), pixel)
    text_axial = np.concatenate([text_sent, text_sent], axis=-1)
    axial_block = np.concatenate([text_axial, img_axial], axis=0)

    table = np.concatenate([text_block, axial_block], axis=-1)
    # a factory call, so a `with torch.device(...)` block places it too
    return torch.tensor(table, dtype=torch.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...) on the last axis."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


def apply_rotary(angles: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotate the first `angles.shape[-1]` channels of t; pass the rest.

    angles: [..., n, d_rot] broadcastable against t[..., n, :d_rot].
    """
    d_rot = angles.shape[-1]
    angles = angles.to(t.dtype)
    t_rot, t_pass = t[..., :d_rot], t[..., d_rot:]
    t_rot = t_rot * torch.cos(angles) + _rotate_half(t_rot) * torch.sin(angles)
    return torch.cat([t_rot, t_pass], dim=-1)
