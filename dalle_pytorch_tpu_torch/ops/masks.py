"""Static attention-mask builders (numpy), copied from the JAX package's
`ops/masks.py` so the port needs nothing from it.

Convention: True = may attend. Masks are [padded_seq, padded_seq] with
padded_seq = text_len + image_fmap_size**2, where text_len counts <bos>.
The cached dense attention path row-slices them at the decode position.
"""

from __future__ import annotations

import numpy as np


def causal_mask(n: int) -> np.ndarray:
    """Lower-triangular allowed mask."""
    return np.tril(np.ones((n, n), dtype=bool))


def axial_static_mask(seq_len: int, image_fmap_size: int, axis: int) -> np.ndarray:
    """Axial row (axis=0) / column (axis=1) attention: every position may
    attend to all text; image positions additionally within their own
    feature-map row or column. Combined with causality at use site."""
    img_seq_len = image_fmap_size**2
    text_len = seq_len + 1 - img_seq_len
    total = text_len + img_seq_len

    mask = np.zeros((total, total), dtype=bool)
    mask[:, :text_len] = True
    img = np.arange(img_seq_len)
    rows, cols = img // image_fmap_size, img % image_fmap_size
    same = (rows[:, None] == rows[None, :]) if axis == 0 else (cols[:, None] == cols[None, :])
    mask[text_len:, text_len:] = same
    return mask


def conv_like_mask(
    seq_len: int,
    image_fmap_size: int,
    kernel_size: int = 5,
    dilation: int = 1,
) -> np.ndarray:
    """Convolutional sparse pattern: text attends causally to text; an
    image query at (r, c) attends to all text plus the causally padded
    dilated k x k neighbourhood at or before its own row and column."""
    assert kernel_size % 2 == 1, "kernel size must be odd"
    img_seq_len = image_fmap_size**2
    text_len = seq_len + 1 - img_seq_len
    total = text_len + img_seq_len
    eff = (kernel_size - 1) * dilation + 1
    sp = eff // 2

    mask = np.zeros((total, total), dtype=bool)
    mask[:text_len, :text_len] = causal_mask(text_len)
    mask[text_len:, :text_len] = True

    img_block = np.zeros((img_seq_len, img_seq_len), dtype=bool)
    for r in range(image_fmap_size):
        for c in range(image_fmap_size):
            q = r * image_fmap_size + c
            for i in range(kernel_size):
                for j in range(kernel_size):
                    kr, kc = r - 2 * sp + i * dilation, c - 2 * sp + j * dilation
                    if 0 <= kr < image_fmap_size and 0 <= kc < image_fmap_size:
                        img_block[q, kr * image_fmap_size + kc] = True
    mask[text_len:, text_len:] = img_block
    return mask


def block_sparse_layout(
    seq_len: int,
    block: int = 16,
    num_local_blocks: int = 4,
    num_random_blocks: int | None = None,
    global_block_indices: tuple[int, ...] | list[int] = (),
    causal: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """Block-level layout with VariableSparsityConfig semantics: a sliding
    window of local blocks, seeded random earlier blocks, and global
    (text) blocks. Returns [nb, nb] bool, True = block pair computed."""
    assert seq_len % block == 0, "seq_len must be divisible by block size"
    nb = seq_len // block
    if num_random_blocks is None:
        num_random_blocks = max(nb // 4, 1)
    rng = np.random.RandomState(seed)

    layout = np.zeros((nb, nb), dtype=bool)
    for i in range(nb):
        lo = max(0, i - num_local_blocks + 1)
        layout[i, lo : i + 1] = True
        hi = i + 1 if causal else nb
        if num_random_blocks > 0 and hi > 0:
            layout[i, rng.randint(0, hi, size=num_random_blocks)] = True
    for g in global_block_indices:
        layout[:, g] = True
        layout[g, : g + 1 if causal else nb] = True
    if causal:
        layout &= np.tril(np.ones((nb, nb), dtype=bool))
    return layout


def block_layout_to_token_mask(layout: np.ndarray, block: int, causal: bool = True) -> np.ndarray:
    """Expand a block layout to a token-level allowed mask."""
    mask = np.kron(layout, np.ones((block, block), dtype=bool))
    if causal:
        mask &= causal_mask(mask.shape[0])
    return mask
