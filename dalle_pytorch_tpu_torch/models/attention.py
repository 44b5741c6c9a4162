"""Multi-head causal attention of the DALLE transformer, cached and uncached.

Counterpart of the JAX package's `models/attention.py:Attention`.

Cached branch, with a scalar cache `index` (every batch row at one
position — the micro-batch decode): project q/k/v, apply rotary to q, k
AND v at positions index..index+n-1, write k/v into the cache at `index`,
then attend over the written prefix. Dispatch mirrors
`_use_flash_decode`: layers without a pattern mask go to the flash-decode
kernel wrapper when `attn_impl="flash"`, or under "auto" when the cache
holds at least AUTO_FLASH_DECODE_MIN_LEN positions; pattern-masked layers
and "dense" run `dense_attention` over the causal + row-sliced pattern
mask. The cache is updated in place (the reference returns a new one):
one copy of the KV cache stays alive, not two.

Uncached branch (training, a whole sequence from position 0): rotary
rows [:n] on q, k and v, then `use_flash` as the reference's `_use_flash`:
"flash" forces the flash-attention kernels, "auto" takes them from
AUTO_FLASH_MIN_SEQ tokens on, a key-padding mask keeps "auto" dense. The
flash arm runs causal for full layers and the composed causal + pattern
mask (`full_mask`, prepared once per length) for patterned ones; the
dense arm masks with the composed mask and the key mask. Output dropout
follows `to_out`, active in training mode. Both thresholds are the
reference's; choosing them for the H100 is later work.

"lib_flash" names the reference's library TPU kernel. The port has no
library kernel: it runs the port's own flash-attention kernels where the
reference runs the library one (uncached, plain causal layers only) and
stays dense where the reference does (the cached branch).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.ops.attention_core import dense_attention
from dalle_pytorch_tpu_torch.ops.flash_attention import FlashMask, flash_attention, flash_mask
from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention
from dalle_pytorch_tpu_torch.ops.rotary import apply_rotary

AUTO_FLASH_MIN_SEQ = 1024
AUTO_FLASH_DECODE_MIN_LEN = 512
ATTN_IMPLS = ("auto", "flash", "dense", "lib_flash")


class Attention(nn.Module):
    """Multi-head causal attention, over a decode cache or a whole
    sequence, with an optional static pattern mask ([P, P] bool, True =
    attend)."""

    def __init__(
        self,
        dim: int,
        heads: int = 8,
        dim_head: int = 64,
        stable: bool = False,
        static_mask: Optional[np.ndarray] = None,
        attn_impl: str = "auto",
        dropout: float = 0.0,
    ):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.heads, self.dim_head = heads, dim_head
        self.stable = stable
        self.attn_impl = attn_impl
        self.dropout = dropout
        self._flash_masks: Dict[tuple, FlashMask] = {}
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.static_mask: Optional[torch.Tensor]
        self.register_buffer(
            "static_mask",
            None if static_mask is None else torch.tensor(np.asarray(static_mask, bool)),
            persistent=False,
        )

    def use_flash_decode(self, max_len: int) -> bool:
        """Cached dispatch; "dense" and "lib_flash" stay dense."""
        if self.static_mask is not None:
            return False
        if self.attn_impl == "flash":
            return True
        return self.attn_impl == "auto" and max_len >= AUTO_FLASH_DECODE_MIN_LEN

    def use_flash(self, n: int, key_mask: Optional[torch.Tensor]) -> bool:
        """Uncached dispatch, the reference's `_use_flash`: static masks run
        on the kernels, a dynamic key-padding mask stays dense."""
        if self.attn_impl == "lib_flash":
            if key_mask is not None or self.static_mask is not None:
                raise ValueError(
                    'attn_impl="lib_flash" supports plain causal attention only '
                    '(no key-padding or static masks); use "flash" or "dense"'
                )
            return True
        if self.attn_impl == "flash":
            if key_mask is not None:
                raise ValueError(
                    'attn_impl="flash" does not support a dynamic key-padding '
                    'mask; encode padding statically or use attn_impl="dense"'
                )
            return True
        if self.attn_impl == "dense" or key_mask is not None:
            return False
        return n >= AUTO_FLASH_MIN_SEQ

    def full_mask(self, n_q: int, n_k: int) -> np.ndarray:
        """Host composition of causal + static pattern, cropped (the
        reference's `_full_mask`)."""
        mask = np.tril(np.ones((n_k, n_k), dtype=bool))[n_k - n_q :, :]
        if self.static_mask is not None:
            mask = mask & self.static_mask[n_k - n_q : n_k, :n_k].cpu().numpy()
        return mask

    def _flash_mask(self, n: int, device) -> FlashMask:
        key = (n, str(device))
        if key not in self._flash_masks:
            self._flash_masks[key] = flash_mask(self.full_mask(n, n), device)
        return self._flash_masks[key]

    def forward(
        self,
        x: torch.Tensor,
        cache: Optional[dict] = None,
        rotary: Optional[torch.Tensor] = None,
        key_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x [B, n, dim]. With a cache: positions cache["index"]..+n-1; the
        cache holds k/v [B, H, max_len, dim_head] and the Python int
        `index`, all updated in place. Without: positions 0..n-1, with an
        optional key-padding mask [B, n] (True = valid key)."""
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        q, k, v = (
            t.reshape(b, n, h, dh).transpose(1, 2)
            for t in self.to_qkv(x).chunk(3, dim=-1)
        )
        if cache is None:
            out = self._attend_uncached(q, k, v, rotary, key_mask)
        else:
            out = self._attend_cached(q, k, v, cache, rotary)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))
        return F.dropout(out, self.dropout, self.training)

    def _attend_uncached(self, q, k, v, rotary, key_mask):
        n = q.shape[2]
        if rotary is not None:
            rot = rotary[:n][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        if self.use_flash(n, key_mask):
            mask = None if self.static_mask is None else self._flash_mask(n, q.device)
            return flash_attention(q, k, v, mask=mask, causal=True)
        mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        if self.static_mask is not None:
            mask = mask & self.static_mask[:n, :n]
        mask = mask[None, None]
        if key_mask is not None:
            mask = mask & key_mask[:, None, None, :].bool()
        return dense_attention(q, k, v, mask=mask, stable=self.stable)

    def _attend_cached(self, q, k, v, cache, rotary):
        b, _, n, _ = q.shape
        index = cache["index"]
        if rotary is not None:
            rot = rotary[index : index + n][None, None]  # [1, 1, n, d_rot]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        ck, cv = cache["k"], cache["v"]
        ck[:, :, index : index + n] = k
        cv[:, :, index : index + n] = v
        max_len = ck.shape[2]
        if self.use_flash_decode(max_len):
            lengths = torch.full((b,), index + n, dtype=torch.int32, device=q.device)
            out = flash_decode_attention(q.contiguous(), ck, cv, lengths)
        else:
            pos = torch.arange(max_len, device=q.device)
            mask = pos[None, :] <= index + torch.arange(n, device=q.device)[:, None]
            if self.static_mask is not None:
                # rows index..index+n of the pattern; the masks are built at
                # (or, block-sparse, above) the cache length, so cropping
                # columns is all the reference's `mask_rows_at` padding does
                mask = mask & self.static_mask[index : index + n, :max_len]
            out = dense_attention(q, ck, cv, mask=mask[None, None], stable=self.stable)
        cache["index"] = index + n
        return out
