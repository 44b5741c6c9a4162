"""Cached multi-head attention of the DALLE transformer.

Counterpart of the cached branch of the JAX package's
`models/attention.py:Attention` with a scalar cache `index` (every batch
row at one position — the micro-batch decode): project q/k/v, apply
rotary to q, k AND v at positions index..index+n-1, write k/v into the
cache at `index`, then attend over the written prefix.

Dispatch mirrors `Attention._use_flash_decode`: layers without a pattern
mask go to the flash-decode kernel wrapper when `attn_impl="flash"`, or
under "auto" when the cache holds at least AUTO_FLASH_DECODE_MIN_LEN
positions; pattern-masked layers and "dense" run `dense_attention` over
the causal + row-sliced pattern mask. The threshold is the reference's;
choosing one for the H100 is later work.

The cache is updated in place (the reference returns a new one): one copy
of the KV cache stays alive, not two.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from dalle_pytorch_tpu_torch.ops.attention_core import dense_attention
from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention
from dalle_pytorch_tpu_torch.ops.rotary import apply_rotary

AUTO_FLASH_DECODE_MIN_LEN = 512
ATTN_IMPLS = ("auto", "flash", "dense")


class Attention(nn.Module):
    """Multi-head causal attention over a decode cache, with an optional
    static pattern mask ([P, P] bool, True = attend)."""

    def __init__(
        self,
        dim: int,
        heads: int = 8,
        dim_head: int = 64,
        stable: bool = False,
        static_mask: Optional[np.ndarray] = None,
        attn_impl: str = "auto",
    ):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.heads, self.dim_head = heads, dim_head
        self.stable = stable
        self.attn_impl = attn_impl
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
        if self.static_mask is not None or self.attn_impl == "dense":
            return False
        return self.attn_impl == "flash" or max_len >= AUTO_FLASH_DECODE_MIN_LEN

    def forward(
        self, x: torch.Tensor, cache: dict, rotary: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """x [B, n, dim] at positions cache["index"]..+n-1; cache holds
        k/v [B, H, max_len, dim_head] and the Python int `index`, all
        updated in place."""
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        q, k, v = (
            t.reshape(b, n, h, dh).transpose(1, 2)
            for t in self.to_qkv(x).chunk(3, dim=-1)
        )
        index = cache["index"]
        if rotary is not None:
            rot = rotary[index : index + n][None, None]  # [1, 1, n, d_rot]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        ck, cv = cache["k"], cache["v"]
        ck[:, :, index : index + n] = k
        cv[:, :, index : index + n] = v
        max_len = ck.shape[2]
        if self.use_flash_decode(max_len):
            lengths = torch.full((b,), index + n, dtype=torch.int32, device=x.device)
            out = flash_decode_attention(q.contiguous(), ck, cv, lengths)
        else:
            pos = torch.arange(max_len, device=x.device)
            mask = pos[None, :] <= index + torch.arange(n, device=x.device)[:, None]
            if self.static_mask is not None:
                # rows index..index+n of the pattern; the masks are built at
                # (or, block-sparse, above) the cache length, so cropping
                # columns is all the reference's `mask_rows_at` padding does
                mask = mask & self.static_mask[index : index + n, :max_len]
            out = dense_attention(q, ck, cv, mask=mask[None, None], stable=self.stable)
        cache["index"] = index + n
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))
