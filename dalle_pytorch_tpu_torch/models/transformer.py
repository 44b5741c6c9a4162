"""The DALLE transformer trunk, unrolled executor: cached decode and the
uncached (training) forward.

Counterpart of the JAX package's `models/transformer.py:Transformer` with
`executor="unrolled"` (`_half_attn`, `_half_ff`, `_layer`, `__call__`):
per layer, LayerNorm -> token shift -> attention -> [sandwich norm] ->
LayerScale, then the same around the GEGLU feed-forward. Cached decode
shifts against a ring; the uncached forward shifts the whole sequence,
runs the layers in reverse order under `reverse_model`, applies attention
and feed-forward dropout in training mode, and with `reversible=True`
recomputes each layer in the backward pass (`torch.utils.checkpoint`, the
reference's `reversible_impl="remat"`; its RNG state is restored, so
dropout masks match). `reversible_impl="revnet"` is not ported.
Supported: attention-type cycling over {full, axial_row, axial_col,
conv_like, sparse} (static pattern masks), cross-layer sharing
(`shared_attn_ids` / `shared_ff_ids`), LayerScale init by depth, sandwich
norm, stable softmax, token shift and rotary each on or off.

Parity notes: flax's `nn.gelu` is the tanh approximation and flax's
LayerNorm uses eps 1e-6 and normalizes in float32.

The decode cache mirrors the reference's tree — {"layer_{i}": {"attn":
{"k", "v", "index"[, "k_scale", "v_scale"]}, "shift_attn", "shift_ff"}}
— with the index a Python int, or a [B] tensor for per-row slots; it is
updated in place. The paged cache (`make_paged_decode_cache`) has the same
keys with K/V (and scales) as page pools shared by all rows.
"""

from __future__ import annotations

import math
from itertools import cycle, islice
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dalle_pytorch_tpu_torch.models.attention import Attention
from dalle_pytorch_tpu_torch.ops.masks import (
    axial_static_mask,
    block_layout_to_token_mask,
    block_sparse_layout,
    conv_like_mask,
)
from dalle_pytorch_tpu_torch.ops.rotary import build_dalle_rotary
from dalle_pytorch_tpu_torch.ops.shift import (
    shift_ring_from_prefill,
    shift_token_step,
    shift_tokens_dalle,
)


def layerscale_init(layer_index: int) -> float:
    """LayerScale init epsilon by 1-based layer index."""
    if layer_index <= 18:
        return 0.1
    if layer_index <= 24:
        return 1e-5
    return 1e-6


class LayerNorm(nn.Module):
    """LayerNorm with flax's numerics: eps 1e-6, statistics in float32,
    output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps
        )
        return y.to(x.dtype)


class FeedForward(nn.Module):
    """GEGLU feed-forward: Linear(dim, 2*hidden) -> x * gelu_tanh(gates)
    -> dropout -> Linear(hidden, dim)."""

    def __init__(self, dim: int, mult: float = 4.0, dropout: float = 0.0):
        super().__init__()
        hidden = int(dim * mult)
        self.dropout = dropout
        self.dense_0 = nn.Linear(dim, hidden * 2)
        self.dense_1 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gates = self.dense_0(x).chunk(2, dim=-1)
        x = F.dropout(x * F.gelu(gates, approximate="tanh"), self.dropout, self.training)
        return self.dense_1(x)


def build_static_mask(
    attn_type: str,
    seq_len: int,
    image_fmap_size: Optional[int],
    layer_ind: int,
    sparse_block: int = 16,
) -> Optional[np.ndarray]:
    """Pattern mask of one attention type (None for "full")."""
    if attn_type == "full":
        return None
    if image_fmap_size is None:
        raise ValueError(f"attn_type {attn_type} needs image_fmap_size")
    if attn_type == "axial_row":
        return axial_static_mask(seq_len, image_fmap_size, axis=0)
    if attn_type == "axial_col":
        return axial_static_mask(seq_len, image_fmap_size, axis=1)
    if attn_type == "conv_like":
        return conv_like_mask(seq_len, image_fmap_size)
    if attn_type == "sparse":
        padded = sparse_block * math.ceil((seq_len + 1) / sparse_block)
        text_len = seq_len + 1 - image_fmap_size**2
        layout = block_sparse_layout(
            padded,
            block=sparse_block,
            num_random_blocks=max(padded // sparse_block // 4, 1),
            global_block_indices=tuple(range(math.ceil(text_len / sparse_block))),
            causal=True,
            seed=layer_ind,
        )
        return block_layout_to_token_mask(layout, sparse_block, causal=True)
    raise ValueError(f'attention type "{attn_type}" is not valid')


class Transformer(nn.Module):
    """Transformer stack with the DALL-E features: causal (the DALLE
    trunk) or, with `causal=False`, bidirectional (CLIP's encoders)."""

    def __init__(
        self,
        dim: int,
        depth: int,
        seq_len: int,
        heads: int = 8,
        dim_head: int = 64,
        ff_mult: float = 4.0,
        attn_types: Optional[Sequence[str]] = None,
        image_fmap_size: Optional[int] = None,
        stable: bool = False,
        sandwich_norm: bool = False,
        shift_tokens: bool = False,
        rotary_emb: bool = True,
        shared_attn_ids: Optional[Sequence[int]] = None,
        shared_ff_ids: Optional[Sequence[int]] = None,
        attn_impl: str = "auto",
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        reversible: bool = False,
        reversible_impl: str = "remat",
        causal: bool = True,
    ):
        super().__init__()
        if (shift_tokens or rotary_emb) and image_fmap_size is None:
            raise ValueError("shift_tokens / rotary_emb need image_fmap_size")
        if reversible and reversible_impl != "remat":
            raise NotImplementedError(
                f"reversible_impl={reversible_impl!r} (the two-stream RevNet "
                "executor) is not ported; it is ROADMAP Queue 1 item 5 "
                "'revnet'. reversible_impl='remat' is"
            )
        self.depth = depth
        self.reversible = reversible
        self.image_fmap_size = image_fmap_size
        self.shift_tokens = shift_tokens
        self.sandwich_norm = sandwich_norm
        self.text_len = (
            seq_len - image_fmap_size**2 + 1 if image_fmap_size is not None else seq_len
        )

        types = list(islice(cycle(tuple(attn_types) if attn_types else ("full",)), depth))
        self.attn_ids = list(islice(cycle(shared_attn_ids or range(depth)), depth))
        self.ff_ids = list(islice(cycle(shared_ff_ids or range(depth)), depth))
        self.attn = nn.ModuleDict()
        attn_type_of = {}
        for ind, (attn_type, attn_id) in enumerate(zip(types, self.attn_ids)):
            if attn_id in attn_type_of:
                if attn_type_of[attn_id] != attn_type:
                    raise ValueError(
                        "attn_types do not match shared_attn_ids "
                        f"(ind = {ind}, attn_type = {attn_type!r}, "
                        f"reused_attn_type = {attn_type_of[attn_id]!r})"
                    )
                continue
            attn_type_of[attn_id] = attn_type
            self.attn[str(attn_id)] = Attention(
                dim, heads=heads, dim_head=dim_head, stable=stable,
                static_mask=build_static_mask(attn_type, seq_len, image_fmap_size, ind),
                attn_impl=attn_impl,
                dropout=attn_dropout,
                seq_len=seq_len,
                causal=causal,
            )
        self.ff = nn.ModuleDict(
            {str(i): FeedForward(dim, ff_mult, ff_dropout) for i in dict.fromkeys(self.ff_ids)}
        )
        self.attn_norms = nn.ModuleList(LayerNorm(dim) for _ in range(depth))
        self.ff_norms = nn.ModuleList(LayerNorm(dim) for _ in range(depth))
        if sandwich_norm:
            self.attn_norms_out = nn.ModuleList(LayerNorm(dim) for _ in range(depth))
            self.ff_norms_out = nn.ModuleList(LayerNorm(dim) for _ in range(depth))
        self.attn_scales = nn.ParameterList(
            nn.Parameter(torch.full((1, 1, dim), layerscale_init(i + 1)))
            for i in range(depth)
        )
        self.ff_scales = nn.ParameterList(
            nn.Parameter(torch.full((1, 1, dim), layerscale_init(i + 1)))
            for i in range(depth)
        )
        self.rotary_table: Optional[torch.Tensor]
        self.register_buffer(
            "rotary_table",
            build_dalle_rotary(self.text_len, image_fmap_size, dim_head) if rotary_emb else None,
            persistent=False,
        )

    def _shift(self, h: torch.Tensor, lc: Optional[dict], ring_key: str, pos) -> torch.Tensor:
        """Token shift. Uncached: the whole sequence. Cached prefill (n > 1,
        from position 0): batch shift and a fresh ring in lc[ring_key]; one
        token: streaming shift against that ring at `pos`."""
        if lc is None:
            return shift_tokens_dalle(h, self.text_len, self.image_fmap_size)
        if h.shape[1] > 1:
            lc[ring_key] = shift_ring_from_prefill(h, self.image_fmap_size)
            return shift_tokens_dalle(h, self.text_len, self.image_fmap_size)
        h, lc[ring_key] = shift_token_step(
            h, lc[ring_key], pos, self.text_len, self.image_fmap_size
        )
        return h

    def _half_attn(self, i: int, x, lc=None, pos=None, key_mask=None) -> torch.Tensor:
        """Attention half-block: norm -> shift -> attn -> [sandwich] ->
        LayerScale; returns the residual branch. `lc` is the layer's decode
        cache (None uncached), `pos` its position before this call."""
        h = self.attn_norms[i](x)
        if self.shift_tokens:
            h = self._shift(h, lc, "shift_attn", pos)
        h = self.attn[str(self.attn_ids[i])](
            h, None if lc is None else lc["attn"], rotary=self.rotary_table, key_mask=key_mask
        )
        if self.sandwich_norm:
            h = self.attn_norms_out[i](h)
        return h * self.attn_scales[i].to(h.dtype)

    def _half_ff(self, i: int, x, lc=None, pos=None) -> torch.Tensor:
        h = self.ff_norms[i](x)
        if self.shift_tokens:
            h = self._shift(h, lc, "shift_ff", pos)
        h = self.ff[str(self.ff_ids[i])](h)
        if self.sandwich_norm:
            h = self.ff_norms_out[i](h)
        return h * self.ff_scales[i].to(h.dtype)

    def _layer(self, i: int, x, key_mask=None, lc=None) -> torch.Tensor:
        pos = None if lc is None else lc["attn"]["index"]  # before attention advances it
        x = x + self._half_attn(i, x, lc, pos, key_mask)
        return x + self._half_ff(i, x, lc, pos)

    def forward(
        self,
        x: torch.Tensor,
        cache: Optional[dict] = None,
        reverse_model: bool = False,
        key_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x [B, n, dim]. With a cache: at the cache's position, updating it
        in place. Without: the whole sequence from position 0, layers in
        reverse order under `reverse_model`, key-padding mask [B, n]."""
        if cache is not None:
            for i in range(self.depth):
                x = self._layer(i, x, lc=cache[f"layer_{i}"])
            return x
        order = range(self.depth - 1, -1, -1) if reverse_model else range(self.depth)
        for i in order:
            if self.reversible and torch.is_grad_enabled():
                x = checkpoint(self._layer, i, x, key_mask, use_reentrant=False)
            else:
                x = self._layer(i, x, key_mask)
        return x


def _kv_store_dtype(dtype, kv_dtype):
    """(K/V storage dtype, has scale leaves) for a cache request: None keeps
    K/V in the cache dtype with no scale leaves; "int8" stores them
    quantized beside fp32 per-(position, head) scales."""
    if kv_dtype is None:
        return dtype, False
    if str(kv_dtype) != "int8":
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (None or 'int8')")
    return torch.int8, True


def make_decode_cache(
    depth: int,
    batch: int,
    max_len: int,
    heads: int,
    dim_head: int,
    dim: int,
    image_fmap_size: Optional[int] = None,
    shift_tokens: bool = False,
    dtype=torch.float32,
    device="cpu",
    per_row: bool = False,
    kv_dtype=None,
) -> dict:
    """Fixed-shape decode cache for the unrolled executor, zero-filled.

    `per_row=True` makes each layer's `index` a [batch] int32 tensor, each
    row at its own position (the continuous engine's slot cache); else it
    is the Python int 0. `kv_dtype="int8"` stores K/V as int8 with fp32
    `k_scale`/`v_scale` leaves [batch, heads, max_len]; shift rings stay
    in `dtype`.
    """
    kv_dt, scaled = _kv_store_dtype(dtype, kv_dtype)
    cache = {}
    for i in range(depth):
        attn = {
            "k": torch.zeros((batch, heads, max_len, dim_head), dtype=kv_dt, device=device),
            "v": torch.zeros((batch, heads, max_len, dim_head), dtype=kv_dt, device=device),
            "index": torch.zeros(batch, dtype=torch.int32, device=device) if per_row else 0,
        }
        if scaled:
            for name in ("k_scale", "v_scale"):
                attn[name] = torch.zeros(
                    (batch, heads, max_len), dtype=torch.float32, device=device
                )
        layer = {"attn": attn}
        if shift_tokens:
            for name in ("shift_attn", "shift_ff"):
                layer[name] = torch.zeros(
                    (batch, image_fmap_size, dim), dtype=dtype, device=device
                )
        cache[f"layer_{i}"] = layer
    return cache


def make_paged_decode_cache(
    depth: int,
    batch: int,
    n_pages: int,
    page_size: int,
    heads: int,
    dim_head: int,
    dim: int,
    image_fmap_size: Optional[int] = None,
    shift_tokens: bool = False,
    dtype=torch.float32,
    device="cpu",
    kv_dtype=None,
) -> dict:
    """Block-paged decode cache, zero-filled: per layer K/V pools
    [n_pages, heads, page_size, dim_head] shared by all `batch` rows (int8
    with fp32 `k_scale`/`v_scale` pools [n_pages, heads, page_size] under
    `kv_dtype="int8"`), a [batch] int32 `index`, and the shift rings per
    row as in `make_decode_cache(per_row=True)`. The page table is host
    state, handed in per dispatch (`models/dalle.py`), not stored here."""
    kv_dt, scaled = _kv_store_dtype(dtype, kv_dtype)
    cache = {}
    for i in range(depth):
        pool = (n_pages, heads, page_size)
        attn = {
            "k": torch.zeros(pool + (dim_head,), dtype=kv_dt, device=device),
            "v": torch.zeros(pool + (dim_head,), dtype=kv_dt, device=device),
            "index": torch.zeros(batch, dtype=torch.int32, device=device),
        }
        if scaled:
            for name in ("k_scale", "v_scale"):
                attn[name] = torch.zeros(pool, dtype=torch.float32, device=device)
        layer = {"attn": attn}
        if shift_tokens:
            for name in ("shift_attn", "shift_ff"):
                layer[name] = torch.zeros(
                    (batch, image_fmap_size, dim), dtype=dtype, device=device
                )
        cache[f"layer_{i}"] = layer
    return cache


def set_decode_cache_index(cache: dict, pos: torch.Tensor) -> None:
    """Stamp every layer's cache `index` with the [B] positions `pos`, in
    place. Layers advance in lockstep, so their indices are copies of one
    position; the continuous chunk loop keeps it as per-slot state and
    stamps it before each step, which also keeps retired and free slots
    where they are."""
    pos = pos.to(torch.int32)
    for layer in cache.values():
        layer["attn"]["index"] = pos
