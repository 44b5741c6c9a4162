"""Host-side decode-sparsity policy: the model's static attention layouts
reduced to per-row KV-tile bitmaps for the block-sparse flash-decode
kernel.

Counterpart of the JAX package's `serving/sparsity.py`. The model's
pattern masks (`axial_row`/`axial_col`/`conv_like`/`sparse`) say which KV
positions a decode step can ever read. This module precomputes, per layer
and per image position, the block-level shadow of each pattern (tile width
= the model's `decode_sparse_block`), and the engine hands the per-slot
rows of that table to every chunk (`models/dalle.py:_with_block_bitmap`).
Policy semantics:

  * conservative by construction: a tile any pattern row in the chunk
    window touches is read whole (`ops/masks.py:mask_to_block_bitmap`),
    and a chunk's bitmap is the union over its `chunk_tokens` query
    positions (the kernel's causal/length mask trims inside live tiles);
  * the text prefix (<bos> + text tokens) is always live;
  * "full" layers get all-ones rows (the length skip alone, so the plain
    kernel's bits);
  * inactive slots get all-ones rows: they compute as padding whose
    outputs are discarded.

Everything here is host numpy.
"""

from __future__ import annotations

from itertools import cycle, islice

import numpy as np

from dalle_pytorch_tpu_torch.models.attention import DECODE_SPARSE_BLOCK
from dalle_pytorch_tpu_torch.models.transformer import build_static_mask
from dalle_pytorch_tpu_torch.ops.masks import mask_to_block_bitmap


class DecodeSparsityPolicy:
    """Per-(layer, image-position) KV-tile liveness tables for one model
    (a `DALLE`, its `decode_sparse_block` read as the tile width), for
    chunks of `chunk_tokens`; `max_batch` sizes the emitted tables."""

    def __init__(self, model, chunk_tokens: int, max_batch: int):
        self.max_batch = int(max_batch)
        self.chunk = max(int(chunk_tokens), 1)
        self.text_len = model.text_seq_len + 1  # <bos> + text prefix
        self.image_seq_len = model.image_seq_len
        self.max_len = model.total_seq_len + 1
        block = getattr(model, "decode_sparse_block", None) or DECODE_SPARSE_BLOCK
        # the kernel's block clamp (tiny geometries read as one block)
        self.block = max(min(int(block), self.max_len), 1)
        self.n_blocks = -(-self.max_len // self.block)
        self.depth = model.depth

        attn_types = tuple(model.attn_types) if model.attn_types else ("full",)
        type_per_layer = list(islice(cycle(attn_types), self.depth))

        # per layer: [image_seq_len, n_blocks] bool tile liveness for a
        # chunk starting at image position p (union over the window), or
        # None for all ones. "sparse" layers seed by layer index; the other
        # patterns' tables are layer-independent and shared
        self._windows: list = []
        table_cache: dict = {}
        for ind, t in enumerate(type_per_layer):
            if t == "full":
                self._windows.append(None)
                continue
            key = t if t != "sparse" else f"sparse_{ind}"
            if key not in table_cache:
                mask = np.asarray(
                    build_static_mask(t, model.total_seq_len, model.image_fmap_size, ind)
                )
                # sized to the cache as the dense path's pattern rows are:
                # True-padded up to max_len, then cropped
                if mask.shape[0] < self.max_len:
                    pad = self.max_len - mask.shape[0]
                    mask = np.pad(mask, ((0, pad), (0, pad)), constant_values=True)
                mask = mask[: self.max_len, : self.max_len]
                rows = mask_to_block_bitmap(
                    mask, self.block, n_blocks=self.n_blocks, always_live=self.text_len
                )
                img_rows = rows[self.text_len :][: self.image_seq_len]
                win = np.zeros((self.image_seq_len, self.n_blocks), dtype=bool)
                for off in range(self.chunk):
                    hi = self.image_seq_len - off
                    if hi <= 0:
                        break
                    # win[p] |= rows[p + off]; windows running past the
                    # last image row union fewer rows
                    win[:hi] |= img_rows[off : off + hi]
                table_cache[key] = win
            self._windows.append(table_cache[key])

    # ------------------------------------------------------------ tables

    def chunk_bitmaps(self, img_pos, active) -> np.ndarray:
        """[depth, max_batch, n_blocks] int32 for one chunk, from the
        engine's host mirrors of each slot's image position and liveness.
        Inactive slots and "full" layers get all-ones rows."""
        pos = np.clip(np.asarray(img_pos, np.int64)[: self.max_batch], 0, self.image_seq_len - 1)
        act = np.asarray(active, bool)[: self.max_batch]
        out = np.ones((self.depth, self.max_batch, self.n_blocks), dtype=np.int32)
        for li, win in enumerate(self._windows):
            if win is None:
                continue
            out[li, : len(pos)] = np.where(act[:, None], win[pos], True)
        return out

    def prefill_bitmaps(self, prefill_batch: int) -> np.ndarray:
        """[depth, R, n_blocks] all ones: text rows under every shipped
        pattern read at most the causal text prefix, and tiles above the
        prefill length are dead through the kernel's length bound."""
        return np.ones((self.depth, int(prefill_batch), self.n_blocks), dtype=np.int32)

    # -------------------------------------------------------- accounting

    def count_tiles(self, img_pos, active) -> tuple:
        """(read, skipped) KV tiles of one chunk, summed over active rows
        and layers (per head the counts are equal, so heads are left out).
        `skipped` counts only tiles the length skip alone would have read:
        the policy's own saving."""
        pos = np.clip(np.asarray(img_pos, np.int64)[: self.max_batch], 0, self.image_seq_len - 1)
        act = np.asarray(active, bool)[: self.max_batch]
        if not act.any():
            return 0, 0
        lengths = np.minimum(pos[act] + self.text_len + self.chunk, self.max_len)
        llb = np.maximum(lengths - 1, 0) // self.block  # last live tile
        in_range = np.arange(self.n_blocks)[None, :] <= llb[:, None]  # [A, nb]
        read = skipped = 0
        for win in self._windows:
            if win is None:
                read += int(in_range.sum())
                continue
            live = win[pos[act]] & in_range
            read += int(live.sum())
            skipped += int((in_range & ~live).sum())
        return read, skipped

    def detail(self) -> dict:
        """Static summary of the policy."""
        patterned = [w for w in self._windows if w is not None]
        dead_frac = float(np.mean([1.0 - w.mean() for w in patterned])) if patterned else 0.0
        return {
            "block": self.block,
            "n_blocks": self.n_blocks,
            "patterned_layers": len(patterned),
            "depth": self.depth,
            "static_dead_tile_frac": round(dead_frac, 4),
        }
