"""The DALLE transformer trunk, unrolled executor: cached decode and the
uncached (training) forward, and the conversions to and from the JAX
package's scan-executor parameter layout.

Counterpart of the JAX package's `models/transformer.py:Transformer` with
`executor="unrolled"` (`_half_attn`, `_half_ff`, `_layer`, `__call__`):
per layer, LayerNorm -> token shift -> attention -> [sandwich norm] ->
LayerScale, then the same around the GEGLU feed-forward. Cached decode
shifts against a ring; the uncached forward shifts the whole sequence,
runs the layers in reverse order under `reverse_model`, applies attention
and feed-forward dropout in training mode, and with `reversible=True`
either recomputes each layer in the backward pass (`torch.utils.checkpoint`,
the reference's `reversible_impl="remat"`; its RNG state is restored, so
dropout masks match) or, with `reversible_impl="revnet"`, runs the
two-stream RevNet: x1 = x1 + f_i(x2), x2 = x2 + g_i(x1) over the layers
from x1 = x2 = x, returning (y1 + y2) / 2, where f_i is layer i's attention
half and g_i its feed-forward half. Its backward (`_RevNetFunction`) keeps
only y1 and y2 and rebuilds each layer's inputs from its outputs (x2 = y2
- g(y1), x1 = y1 - f(x2)) while it walks the layers back, so activation
memory does not grow with depth. `reversible_impl="revnet_naive"` is the
same forward differentiated by autograd, the tests' oracle. The RevNet
refuses a key mask and dropout in training mode, as the reference does;
its cached decode advances the same two streams through the cached
halves.
Supported: attention-type cycling over {full, axial_row, axial_col,
conv_like, sparse} (static pattern masks), cross-layer sharing
(`shared_attn_ids` / `shared_ff_ids`), LayerScale init by depth, sandwich
norm, stable softmax, token shift and rotary each on or off.

Parity notes: flax's `nn.gelu` is the tanh approximation and flax's
LayerNorm uses eps 1e-6 and normalizes in float32.

Cached decode has one path, `cached_forward`, over a list of shards:
the stack itself (`Transformer.forward` with a cache) or the shard stacks
of a tensor-parallel model (`parallel/tensor_parallel.py`), whose
attention and FF outputs are summed across shards (`row_parallel`).

The decode cache mirrors the reference's tree — {"layer_{i}": {"attn":
{"k", "v", "index"[, "k_scale", "v_scale"]}, "shift_attn", "shift_ff"}}
— with the index a Python int, or a [B] tensor for per-row slots; it is
updated in place. The paged cache (`make_paged_decode_cache`) has the same
keys with K/V (and scales) as page pools shared by all rows.
"""

from __future__ import annotations

import math
from itertools import cycle, islice
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dalle_pytorch_tpu_torch.models.attention import Attention, read_cached
from dalle_pytorch_tpu_torch.ops.masks import (
    axial_static_mask,
    block_layout_to_token_mask,
    block_sparse_layout,
    conv_like_mask,
)
from dalle_pytorch_tpu_torch.ops.rotary import build_dalle_rotary
from dalle_pytorch_tpu_torch.ops.shift import (
    shift_ring_from_prefill,
    shift_ring_from_prefill_at,
    shift_token_step,
    shift_tokens_dalle,
)
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import row_parallel


REVERSIBLE_IMPLS = ("remat", "revnet", "revnet_naive")


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

    def __init__(self, dim: int, mult: float = 4.0, dropout: float = 0.0, hidden: Optional[int] = None):
        """`hidden` (default int(dim * mult)) sets the width directly: a
        tensor-parallel shard holds hidden / tp units."""
        super().__init__()
        hidden = int(dim * mult) if hidden is None else int(hidden)
        self.dropout = dropout
        #: set on the shards of a tensor-parallel model whose hidden units
        #: are split: `dense_1` is then row-parallel
        self.row_parallel = False
        self.dense_0 = nn.Linear(dim, hidden * 2)
        self.dense_1 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(self.hidden_units(x))

    def hidden_units(self, x: torch.Tensor) -> torch.Tensor:
        """The GEGLU activations before `dense_1`."""
        x, gates = self.dense_0(x).chunk(2, dim=-1)
        return F.dropout(x * F.gelu(gates, approximate="tanh"), self.dropout, self.training)


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
        sp_mesh=None,
    ):
        """`sp_mesh` (a `TrainMesh`) is the ring's mesh under
        attn_impl="ring" (`models/attention.py`)."""
        super().__init__()
        if (shift_tokens or rotary_emb) and image_fmap_size is None:
            raise ValueError("shift_tokens / rotary_emb need image_fmap_size")
        if reversible_impl not in REVERSIBLE_IMPLS:
            raise ValueError(
                f"unknown reversible_impl {reversible_impl!r}; one of {REVERSIBLE_IMPLS}"
            )
        self.depth = depth
        self.reversible = reversible
        self.reversible_impl = reversible_impl
        self.revnet = reversible and reversible_impl != "remat"
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        self.image_fmap_size = image_fmap_size
        self.shift_tokens = shift_tokens
        self.sandwich_norm = sandwich_norm
        self.text_len = (
            seq_len - image_fmap_size**2 + 1 if image_fmap_size is not None else seq_len
        )

        types = list(islice(cycle(tuple(attn_types) if attn_types else ("full",)), depth))
        # what decides whether the JAX scan executor runs this stack
        self.scan_config = dict(
            attn_types=tuple(types), attn_impl=attn_impl, shared_attn_ids=shared_attn_ids,
            shared_ff_ids=shared_ff_ids, reversible=reversible, reversible_impl=reversible_impl,
        )
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
                sp_mesh=sp_mesh,
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
        from position 0): batch shift and a fresh ring in lc[ring_key],
        built at each row's own end when the cache carries a [B]
        "ring_end" (the decode resume); one token: streaming shift against
        that ring at `pos`."""
        if lc is None:
            return shift_tokens_dalle(h, self.text_len, self.image_fmap_size)
        if h.shape[1] > 1:
            ring_end = lc.get("ring_end")
            if ring_end is None:
                lc[ring_key] = shift_ring_from_prefill(h, self.image_fmap_size)
            else:
                lc[ring_key] = shift_ring_from_prefill_at(h, self.image_fmap_size, ring_end)
            return shift_tokens_dalle(h, self.text_len, self.image_fmap_size)
        h, lc[ring_key] = shift_token_step(
            h, lc[ring_key], pos, self.text_len, self.image_fmap_size
        )
        return h

    def _half_attn(self, i: int, x, key_mask=None) -> torch.Tensor:
        """Uncached attention half-block: norm -> shift -> attn ->
        [sandwich] -> LayerScale; returns the residual branch."""
        h = self.attn_norms[i](x)
        if self.shift_tokens:
            h = self._shift(h, None, "shift_attn", None)
        h = self.attn[str(self.attn_ids[i])](h, rotary=self.rotary_table, key_mask=key_mask)
        return _finish(self, "attn", i, h)

    def _half_ff(self, i: int, x) -> torch.Tensor:
        h = self.ff_norms[i](x)
        if self.shift_tokens:
            h = self._shift(h, None, "shift_ff", None)
        return _finish(self, "ff", i, self.ff[str(self.ff_ids[i])](h))

    def _layer(self, i: int, x, key_mask=None) -> torch.Tensor:
        x = x + self._half_attn(i, x, key_mask)
        return x + self._half_ff(i, x)

    def _rev_streams(self, x1, x2, order):
        """The RevNet's two streams: f_i is layer i's attention half, g_i its
        feed-forward half."""
        for i in order:
            x1 = x1 + self._half_attn(i, x2)
            x2 = x2 + self._half_ff(i, x1)
        return x1, x2

    def _half_params(self, i: int):
        """(f_i's parameters, g_i's parameters)."""
        f = [*self.attn[str(self.attn_ids[i])].parameters(), *self.attn_norms[i].parameters(),
             self.attn_scales[i]]
        g = [*self.ff[str(self.ff_ids[i])].parameters(), *self.ff_norms[i].parameters(),
             self.ff_scales[i]]
        if self.sandwich_norm:
            f += list(self.attn_norms_out[i].parameters())
            g += list(self.ff_norms_out[i].parameters())
        return f, g

    def _revnet(self, x: torch.Tensor, order, key_mask) -> torch.Tensor:
        if key_mask is not None:
            raise ValueError("the revnet executor has no key-mask path")
        if self.training and (self.attn_dropout > 0 or self.ff_dropout > 0):
            raise ValueError(
                "the revnet executor requires deterministic execution (no dropout); "
                "use reversible_impl='remat' for dropout training"
            )
        if self.reversible_impl == "revnet_naive" or not torch.is_grad_enabled():
            y1, y2 = self._rev_streams(x, x, order)
            return (y1 + y2) / 2
        params = list(self.parameters())
        return _RevNetFunction.apply(self, tuple(order), x, *params)

    def forward(
        self,
        x: torch.Tensor,
        cache: Optional[dict] = None,
        reverse_model: bool = False,
        key_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x [B, n, dim]. With a cache: at the cache's position, updating it
        in place (`cached_forward`, this stack as its one shard). Without:
        the whole sequence from position 0, key-padding mask [B, n]. Either
        runs the layers in reverse order under `reverse_model`."""
        if cache is not None:
            return cached_forward([self], [x], [cache], reverse_model)[0]
        order = range(self.depth - 1, -1, -1) if reverse_model else range(self.depth)
        if self.revnet:
            return self._revnet(x, order, key_mask)
        for i in order:
            if self.reversible and torch.is_grad_enabled():
                x = checkpoint(self._layer, i, x, key_mask, use_reentrant=False)
            else:
                x = self._layer(i, x, key_mask)
        return x


def cached_forward(
    shards: Sequence[Transformer], xs: Sequence[torch.Tensor], caches: Sequence[dict],
    reverse_model: bool = False,
) -> list:
    """The cached forward of a trunk held as shards: `shards[s]` is shard
    s's stack (the whole stack when there is one shard; else its heads and
    hidden units, `parallel/tensor_parallel.py`), xs[s] the input on its
    device (the same values on every shard) and caches[s] its decode
    cache, at the cache's position and updated in place; the layers in
    reverse order under `reverse_model`. Per layer: each shard's norm and
    token shift (against its own copy of the rings), its heads' K/V writes,
    the read of all shards (`read_cached`, the sharded kernel wrappers),
    then `to_out` row-parallel (the partial products summed, the bias
    added once), sandwich norm and LayerScale; the same around the GEGLU,
    `dense_1` row-parallel. A layer that is not split runs whole on every
    shard. The RevNet advances its two streams through the same halves:
    the attention half reads x2, the feed-forward half x1, both at the
    position before the layer. Returns the outputs, one per shard (equal
    values)."""
    first = shards[0]
    order = range(first.depth - 1, -1, -1) if reverse_model else range(first.depth)
    x1 = x2 = xs = list(xs)
    for i in order:
        lcs = [c[f"layer_{i}"] for c in caches]
        pos = [lc["attn"]["index"] for lc in lcs]  # before attention advances it
        if first.revnet:
            x1 = _add(x1, _cached_half_attn(shards, i, x2, lcs, pos))
            x2 = _add(x2, _cached_half_ff(shards, i, x1, lcs, pos))
        else:
            xs = _add(xs, _cached_half_attn(shards, i, xs, lcs, pos))
            xs = _add(xs, _cached_half_ff(shards, i, xs, lcs, pos))
    if first.revnet:
        return [(a + b) / 2 for a, b in zip(x1, x2)]
    return xs


def _add(xs, hs):
    return [x + h for x, h in zip(xs, hs)]


def _cached_half_attn(shards, i, xs, lcs, pos):
    attns = [tr.attn[str(tr.attn_ids[i])] for tr in shards]
    reads = []
    for tr, attn, x, lc, p in zip(shards, attns, xs, lcs, pos):
        h = tr.attn_norms[i](x)
        if tr.shift_tokens:
            h = tr._shift(h, lc, "shift_attn", p)
        reads.append(attn.write_cached(h, lc["attn"], tr.rotary_table))
    outs = row_parallel([a.to_out for a in attns], read_cached(attns, reads), attns[0].row_parallel)
    return [_finish(tr, "attn", i, F.dropout(o, a.dropout, a.training))
            for tr, a, o in zip(shards, attns, outs)]


def _cached_half_ff(shards, i, xs, lcs, pos):
    ffs = [tr.ff[str(tr.ff_ids[i])] for tr in shards]
    hs = []
    for tr, ff, x, lc, p in zip(shards, ffs, xs, lcs, pos):
        h = tr.ff_norms[i](x)
        if tr.shift_tokens:
            h = tr._shift(h, lc, "shift_ff", p)
        hs.append(ff.hidden_units(h))
    outs = row_parallel([ff.dense_1 for ff in ffs], hs, ffs[0].row_parallel)
    return [_finish(tr, "ff", i, o) for tr, o in zip(shards, outs)]


def _finish(tr: Transformer, half: str, i: int, h: torch.Tensor) -> torch.Tensor:
    """The end of a half block: the sandwich norm and LayerScale."""
    if tr.sandwich_norm:
        h = getattr(tr, f"{half}_norms_out")[i](h)
    return h * getattr(tr, f"{half}_scales")[i].to(h.dtype)


class _RevNetFunction(torch.autograd.Function):
    """The RevNet's memory-saving backward: the forward keeps only the
    streams' outputs y1, y2; the backward walks the layers back and, for
    each, recomputes g(y1), rebuilds x2 = y2 - g(y1), recomputes f(x2) and
    rebuilds x1 = y1 - f(x2), taking the gradients of the input halves and
    of that layer's parameters with `torch.autograd.grad`. The parameters
    are inputs of `apply` and their gradients outputs of `backward` (summed
    over the layers that share them), so `.grad` is written by autograd
    alone. The backward re-enters the forward's autocast state, as
    `torch.amp.custom_fwd` / `custom_bwd` do, for the input's device type
    (cuda or cpu): the bf16 recompute then rounds as the forward did."""

    @staticmethod
    def forward(ctx, tr, order, x, *params):
        dev = x.device.type
        ctx.autocast = (dev, torch.is_autocast_enabled(dev), torch.get_autocast_dtype(dev))
        ctx.tr, ctx.order = tr, order
        y1, y2 = tr._rev_streams(x, x, order)
        ctx.save_for_backward(y1, y2)
        return (y1 + y2) / 2

    @staticmethod
    def backward(ctx, dy):
        tr, order = ctx.tr, ctx.order
        y1, y2 = ctx.saved_tensors
        dy1 = dy2 = dy / 2
        slot = {id(p): k for k, p in enumerate(tr.parameters())}
        grads: Dict[int, torch.Tensor] = {}

        def grad_of(out, h, params, d_out):
            res = torch.autograd.grad(out, (h, *params), d_out, allow_unused=True)
            for p, g in zip(params, res[1:]):
                if g is not None:
                    k = slot[id(p)]
                    grads[k] = g if k not in grads else grads[k] + g
            return res[0]

        dev, enabled, dtype = ctx.autocast
        with torch.enable_grad(), torch.autocast(dev, dtype=dtype, enabled=enabled):
            for i in reversed(order):
                f_params, g_params = tr._half_params(i)
                h = y1.detach().requires_grad_()
                g_out = tr._half_ff(i, h)
                x2 = y2 - g_out.detach()
                dy1 = dy1 + grad_of(g_out, h, g_params, dy2)
                h = x2.detach().requires_grad_()
                f_out = tr._half_attn(i, h)
                x1 = y1 - f_out.detach()
                dy2 = dy2 + grad_of(f_out, h, f_params, dy1)
                y1, y2 = x1, x2
        n = len(slot)
        return (None, None, dy1 + dy2) + tuple(grads.get(k) for k in range(n))


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


def scan_unsupported(
    attn_types: Optional[Sequence[str]] = None,
    attn_impl: str = "auto",
    shared_attn_ids: Optional[Sequence[int]] = None,
    shared_ff_ids: Optional[Sequence[int]] = None,
    reversible: bool = False,
    reversible_impl: str = "remat",
) -> Optional[str]:
    """None if the JAX package's scan executor runs this configuration,
    else its reason (the JAX `Transformer._scan_supported`): the port
    refuses a scan-layout export of such a model, since the JAX package
    could not load it."""
    if attn_types and any(t != "full" for t in attn_types):
        if attn_impl in ("flash", "lib_flash"):
            return (
                f'attn_impl="{attn_impl}" with masked attn_types '
                "(scanned pattern masks are traced; use dense/auto)"
            )
    if shared_attn_ids or shared_ff_ids:
        return "cross-layer weight sharing"
    if reversible and reversible_impl != "remat":
        return "revnet reversible executor"
    if attn_impl == "ring":
        return "ring attention / sp mesh"
    return None


def check_scan_supported(**config) -> None:
    """Raise ValueError, with the JAX package's words, for a configuration
    its scan executor does not run (`scan_unsupported`)."""
    why = scan_unsupported(**config)
    if why is not None:
        raise ValueError(
            f'executor="scan" does not support {why}; use the default unrolled executor'
        )


def _take(a, i):
    return a[i]


def _map_tree(fn: Callable, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _stack_trees(trees, stack: Callable):
    first = trees[0]
    return {
        k: _stack_trees([t[k] for t in trees], stack) if isinstance(first[k], dict)
        else stack([t[k] for t in trees])
        for k in first
    }


def scan_params_to_unrolled(tparams: dict, depth: int, take: Callable = _take) -> dict:
    """A scan-executor Transformer parameter subtree (the reference tree
    under ".../transformer": `scan_stack/layers` with [depth, ...] leaves
    and the stacked LayerScale vectors) as the unrolled executor's
    (`attn_{i}`, `ff_{i}`, norms and scales per layer). `take(leaf, i)`
    slices layer i (numpy indexing by default)."""
    layers = tparams["scan_stack"]["layers"]
    out = {}
    for i in range(depth):
        layer = lambda tree: _map_tree(lambda a: take(a, i), tree)
        out[f"attn_{i}"] = layer(layers["attn"])
        out[f"ff_{i}"] = layer(layers["ff"])
        out[f"attn_norms_{i}"] = layer(layers["norm_attn"])
        out[f"ff_norms_{i}"] = layer(layers["norm_ff"])
        if "norm_attn_out" in layers:
            out[f"attn_norms_out_{i}"] = layer(layers["norm_attn_out"])
            out[f"ff_norms_out_{i}"] = layer(layers["norm_ff_out"])
        out[f"attn_scale_{i}"] = take(tparams["attn_scale_stack"], i)
        out[f"ff_scale_{i}"] = take(tparams["ff_scale_stack"], i)
    return out


def unrolled_params_to_scan(tparams: dict, depth: int, stack: Callable = np.stack) -> dict:
    """The inverse of `scan_params_to_unrolled` (configurations without
    cross-layer sharing): `stack(leaves)` stacks the layers' leaves."""

    def stacked(fmt):
        trees = [tparams[fmt.format(i)] for i in range(depth)]
        if not isinstance(trees[0], dict):
            return stack(trees)
        return _stack_trees(trees, stack)

    layers = {
        "attn": stacked("attn_{}"),
        "ff": stacked("ff_{}"),
        "norm_attn": stacked("attn_norms_{}"),
        "norm_ff": stacked("ff_norms_{}"),
    }
    if "attn_norms_out_0" in tparams:
        layers["norm_attn_out"] = stacked("attn_norms_out_{}")
        layers["norm_ff_out"] = stacked("ff_norms_out_{}")
    return {
        "scan_stack": {"layers": layers},
        "attn_scale_stack": stacked("attn_scale_{}"),
        "ff_scale_stack": stacked("ff_scale_{}"),
    }
