"""Static attention-mask builders (numpy), copied from the JAX package's
`ops/masks.py` so the port needs nothing from it.

Convention: True = may attend. Masks are [padded_seq, padded_seq] with
padded_seq = text_len + image_fmap_size**2, where text_len counts <bos>.
The cached dense attention path row-slices them at the decode position;
the uncached flash path analyses them into tile layouts
(`mask_block_layout`, the JAX package's `ops/pallas_attention.py`
function of that name); the decode-sparsity policy reduces them to KV-tile
bitmaps (`mask_to_block_bitmap`).
"""

from __future__ import annotations

import math

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


def mask_to_block_bitmap(
    mask: np.ndarray,
    block: int,
    n_blocks: int | None = None,
    always_live: int = 0,
) -> np.ndarray:
    """Reduce a token-level allowed mask to per-query-row KV-tile liveness:
    bitmap[i, j] says whether query row i may read any position of KV tile
    j (positions [j*block, (j+1)*block)), the decode-time contract of the
    block-sparse flash-decode kernel. Conservative by construction: a tile
    with one allowed key is read whole, and the kernel's causal/length
    mask trims the rest.

    `n_blocks` widens (False-pads) or crops the tile axis to the serving
    cache's ceil(max_len / block); `always_live` forces the first tiles
    covering that many key positions live (<bos> + text, which every
    decode policy keeps resident).
    """
    t_q, t_k = mask.shape
    if n_blocks is None:
        n_blocks = -(-t_k // block)
    out = np.zeros((t_q, n_blocks), dtype=bool)
    for j in range(n_blocks):
        lo = j * block
        if lo >= t_k:
            break
        out[:, j] = mask[:, lo : min(lo + block, t_k)].any(axis=1)
    if always_live > 0:
        out[:, : -(-min(always_live, n_blocks * block) // block)] = True
    return out


def mask_block_layout(mask: np.ndarray, block_q: int, block_k: int):
    """(padded token mask, [nq, nk] int32 occupancy layout) of a static mask
    at tiles of block_q x block_k.

    Every real query row must attend to at least one key: with the finite
    masked-score sentinel an all-masked row would softmax to a uniform
    average of one tile's values instead of anything meaningful, so such a
    mask is rejected.
    """
    mask = np.asarray(mask, dtype=bool)
    empty = ~mask.any(axis=1)
    if empty.any():
        raise ValueError(
            f"static attention mask has {int(empty.sum())} fully-masked query "
            f"row(s) (first: {int(np.argmax(empty))}); every query must be "
            "allowed to attend to at least one key"
        )
    nq = math.ceil(mask.shape[0] / block_q)
    nk = math.ceil(mask.shape[1] / block_k)
    padded = np.zeros((nq * block_q, nk * block_k), dtype=bool)
    padded[: mask.shape[0], : mask.shape[1]] = mask
    blocks = padded.reshape(nq, block_q, nk, block_k)
    layout = blocks.any(axis=(1, 3)).astype(np.int32)
    return padded, layout
