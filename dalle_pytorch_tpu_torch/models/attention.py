"""Multi-head attention of the DALLE transformer (causal) and of CLIP's
encoders (`causal=False`), cached and uncached.

Counterpart of the JAX package's `models/attention.py:Attention`.

Cached branch: project q/k/v, apply rotary to q, k AND v at positions
index..index+n-1, write k/v into the cache at `index`, then attend over
the written prefix. The cache `index` is a Python int (every batch row at
one position — the micro-batch decode) or a [B] int32 tensor (each row at
its own position — the continuous engine's slot cache; rotary rows,
cache writes and the causal and pattern masks then go per row). A cache
with `k_scale`/`v_scale` leaves is int8: k/v are quantized after rotary
(`_kv_quantize`) and read back dequantized. A `block_bitmap` entry (the
decode-sparsity policy's [B, nb] tile bitmap, with its "sparse_block"
width) supersedes the pattern masks. Dispatch mirrors `_use_flash_decode`:
layers without a pattern mask, and every layer under a bitmap, go to the
flash-decode kernel wrappers (block-sparse with a bitmap) when
`attn_impl="flash"`, or under "auto" when the cache holds at least
AUTO_FLASH_DECODE_MIN_LEN positions; the rest run `dense_attention` over
the causal + pattern (or bitmap) mask. The cache is updated in place (the
reference returns a new one): one copy of the KV cache stays alive, not
two.

A cache with a "page_table" entry ([B, n_pages] int32, put there per
dispatch by `models/dalle.py`) is paged: k/v (and scales) are pools [P,
H, page, D] shared by all rows, the virtual length is min(n_pages * page,
seq_len + 1) (the slotted cache's), and each row's writes scatter to
(page_table[b, pos // page], :, pos % page) with pos clamped per position
to the last virtual one. The flash arm goes through
`paged_decode_attention` (its impl from the cache's "paged_impl" entry),
the dense arm reads `paged_gather` views. Released rows' tables point at
the garbage page, so their writes land there; duplicate scatter targets
(many rows on page 0) then race, harmlessly.

The cached branch runs in two steps over the shards of a layer (one
shard, the module itself, unless the model is split by head,
`parallel/tensor_parallel.py`): `write_cached` on each shard
(projections, rotary, its heads' K/V writes, the index advance), then
`read_cached` of all shards at once, the flash arm through the head-split
wrappers (`sharded_flash_decode_attention`,
`sharded_paged_decode_attention`), the dense arm per shard.

Uncached branch (training, a whole sequence from position 0): rotary
rows [:n] on q, k and v, then `use_flash` as the reference's `_use_flash`:
"flash" forces the flash-attention kernels, "auto" takes them from
AUTO_FLASH_MIN_SEQ tokens on, a key-padding mask keeps "auto" dense. The
flash arm runs causal for full layers and the composed causal + pattern
mask (`full_mask`, prepared once per length) for patterned ones; the
dense arm masks with the composed mask and the key mask. `causal=False`
(CLIP's encoders) drops the causal rule from both arms: the flash arm
runs the kernels' all-keys arm, the dense arm only the pattern and key
masks (the cached branch is always causal: decode feeds a prefix). Output dropout
follows `to_out`, active in training mode. Both thresholds are the
reference's; choosing them for the H100 is later work.

"ring" (`sp_mesh`: a `TrainMesh`) runs the uncached branch as ring
attention over the mesh's sp ranks (`parallel/ring.py:
ring_attention_sharded`): every sp rank holds the whole sequence, takes
its block of q, k and v, and all-gathers the outputs. The JAX module's
four refusals are ValueErrors here: no sp_mesh, a static or key-padding
mask, `stable`, or a length the sp axis does not divide. The cached branch
never runs the ring: it stays dense under "ring", as the reference's
`_use_flash_decode` keeps it (ring is a training layout).

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
from dalle_pytorch_tpu_torch.ops.flash_decode import (
    clamp_block_k,
    expand_bitmap,
    paged_gather,
    sharded_flash_decode_attention,
    sharded_paged_decode_attention,
)
from dalle_pytorch_tpu_torch.ops.rotary import apply_rotary
from dalle_pytorch_tpu_torch.parallel.ring import ring_attention_sharded

AUTO_FLASH_MIN_SEQ = 1024
AUTO_FLASH_DECODE_MIN_LEN = 512
ATTN_IMPLS = ("auto", "flash", "dense", "lib_flash", "ring")
# KV block width of the decode-sparsity bitmaps (the reference's choice;
# a cache's "sparse_block" entry overrides it)
DECODE_SPARSE_BLOCK = 128


def _row_positions(index: torch.Tensor, n: int, length: int) -> torch.Tensor:
    """[B, n] positions index[b]..index[b]+n-1, the start clamped to
    [0, length - n] as the reference's dynamic slices clamp it (a finished
    slot stepped past the cache writes into its spare last position)."""
    start = index.to(torch.long).clamp(0, length - n)
    return start[:, None] + torch.arange(n, device=index.device)


def _cache_write(buf: torch.Tensor, val: torch.Tensor, index) -> None:
    """Write val [B, H, n(, D)] into buf [B, H, S(, D)] in place at sequence
    position `index`: a Python int (every row at one position, the micro
    engine) or a [B] tensor (each row at its own position, the slot
    cache)."""
    n = val.shape[2]
    if not torch.is_tensor(index):
        buf[:, :, index : index + n] = val
        return
    pos = _row_positions(index, n, buf.shape[2])[:, None, :]  # [B, 1, n]
    if buf.dim() == 4:
        pos = pos[..., None]
    buf.scatter_(2, pos.expand(val.shape), val.to(buf.dtype))


def _paged_write(pool: torch.Tensor, val: torch.Tensor, page: torch.Tensor, off: torch.Tensor) -> None:
    """Scatter val [B, H, n(, D)] into pool [P, H, page(, D)] in place at
    (page[b, i], :, off[b, i])."""
    pool[page, :, off] = val.transpose(1, 2).to(pool.dtype)


def _kv_quantize(x: torch.Tensor):
    """Symmetric int8 quantization over the head dim: x [B, H, n, D] ->
    (int8 [B, H, n, D], fp32 scale [B, H, n]). fp32 throughout, round half
    to even, eps 1e-8 so an all-zero row round-trips to zeros."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


class Attention(nn.Module):
    """Multi-head attention, causal unless `causal=False`, over a decode
    cache or a whole sequence, with an optional static pattern mask ([P,
    P] bool, True = attend)."""

    def __init__(
        self,
        dim: int,
        heads: int = 8,
        dim_head: int = 64,
        stable: bool = False,
        static_mask: Optional[np.ndarray] = None,
        attn_impl: str = "auto",
        dropout: float = 0.0,
        seq_len: Optional[int] = None,
        causal: bool = True,
        sp_mesh=None,
    ):
        """`seq_len` (the model's total_seq_len) bounds a paged cache's
        virtual length at seq_len + 1, as the slotted cache's length;
        `sp_mesh` (a `TrainMesh`) is the ring's mesh under
        attn_impl="ring"."""
        super().__init__()
        self.sp_mesh = sp_mesh
        self.causal = causal
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.seq_len = seq_len
        self.heads, self.dim_head = heads, dim_head
        self.stable = stable
        self.attn_impl = attn_impl
        self.dropout = dropout
        self._flash_masks: Dict[tuple, FlashMask] = {}
        #: set on the shards of a tensor-parallel model whose heads are
        #: split: `to_out` is then row-parallel (`parallel/tensor_parallel.py`)
        self.row_parallel = False
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.static_mask: Optional[torch.Tensor]
        self.register_buffer(
            "static_mask",
            None if static_mask is None else torch.tensor(np.asarray(static_mask, bool)),
            persistent=False,
        )

    def use_flash_decode(
        self, max_len: int, has_pattern: Optional[bool] = None, sparse: bool = False
    ) -> bool:
        """Cached dispatch, the reference's `_use_flash_decode`: pattern
        layers stay dense unless the cache carries a policy bitmap (then
        the block-sparse kernel reads them); "dense" and "lib_flash" stay
        dense. `has_pattern` defaults to this layer's own static mask."""
        if has_pattern is None:
            has_pattern = self.static_mask is not None
        if has_pattern and not sparse:
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

    def full_mask(self, n_q: int, n_k: int) -> Optional[np.ndarray]:
        """Host composition of causal + static pattern, cropped (the
        reference's `_full_mask`); None when there is neither."""
        mask = np.tril(np.ones((n_k, n_k), dtype=bool))[n_k - n_q :, :] if self.causal else None
        if self.static_mask is not None:
            pattern = self.static_mask[n_k - n_q : n_k, :n_k].cpu().numpy()
            mask = pattern if mask is None else mask & pattern
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
        cache holds k/v [B, H, max_len, dim_head] (int8 with k_scale/v_scale
        [B, H, max_len]) and `index` (a Python int or a [B] tensor), all
        updated in place. Without: positions 0..n-1, with an optional
        key-padding mask [B, n] (True = valid key)."""
        b, n, _ = x.shape
        if cache is None:
            out = _merge_heads(self._attend_uncached(*self._project(x), rotary, key_mask))
        else:
            out = read_cached([self], [self.write_cached(x, cache, rotary)])[0]
        return F.dropout(self.to_out(out), self.dropout, self.training)

    def _project(self, x: torch.Tensor):
        """(q, k, v) [B, H, n, dim_head] of x [B, n, dim]."""
        b, n, _ = x.shape
        return tuple(
            t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
            for t in self.to_qkv(x).chunk(3, dim=-1)
        )

    def write_cached(self, x: torch.Tensor, cache: dict, rotary: Optional[torch.Tensor] = None) -> dict:
        """The cached branch up to the read, for x [B, n, dim]: the
        projections, rotary, the K/V writes and the index advance; returns
        what the read needs (`read_cached`)."""
        return self._write_cached(*self._project(x), cache, rotary)

    def _attend_uncached(self, q, k, v, rotary, key_mask):
        n = q.shape[2]
        if rotary is not None:
            rot = rotary[:n][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        if self.attn_impl == "ring":
            return self._attend_ring(q, k, v, key_mask)
        if self.use_flash(n, key_mask):
            mask = None if self.static_mask is None else self._flash_mask(n, q.device)
            return flash_attention(q, k, v, mask=mask, causal=self.causal)
        mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril() if self.causal else None
        if self.static_mask is not None:
            pattern = self.static_mask[:n, :n]
            mask = pattern if mask is None else mask & pattern
        if key_mask is not None:
            keys = key_mask[:, None, None, :].bool()
            mask = keys if mask is None else mask & keys
        return dense_attention(q, k, v, mask=mask, stable=self.stable)

    def _attend_ring(self, q, k, v, key_mask):
        """Sequence-parallel exact attention over `sp_mesh`'s sp ranks,
        with the reference's refusals."""
        if self.sp_mesh is None:
            raise ValueError('attn_impl="ring" needs sp_mesh')
        if self.static_mask is not None or key_mask is not None:
            raise ValueError("ring attention supports plain causal/full attention only")
        if self.stable:
            raise ValueError('attn_impl="ring" does not take stable=')
        n, sp = q.shape[2], self.sp_mesh.shape["sp"]
        if n % sp:
            raise ValueError(
                f"sequence length {n} must be divisible by the sp axis ({sp}); note the "
                "uncached generate_images() re-forwards growing prefixes: use the "
                "KV-cached decode path with ring models"
            )
        return ring_attention_sharded(self.sp_mesh, q, k, v, causal=self.causal)

    def _pattern_rows(self, index, n: int, max_len: int) -> torch.Tensor:
        """The static pattern's rows at the chunk's positions, cropped (or
        True-padded) to the cache length: [1, 1, n, L], or [B, 1, n, L]
        for a per-row index (the reference's `mask_rows_at`)."""
        pm = self.static_mask
        if pm.shape[0] < max_len:
            pm = F.pad(pm, (0, max_len - pm.shape[0], 0, max_len - pm.shape[0]), value=True)
        pm = pm[:, :max_len]
        if torch.is_tensor(index):
            return pm[_row_positions(index, n, pm.shape[0])][:, None]
        return pm[index : index + n][None, None]

    def _write_cached(self, q, k, v, cache, rotary) -> dict:
        n = q.shape[2]
        index = cache["index"]
        per_row = torch.is_tensor(index)
        ck, cv = cache["k"], cache["v"]
        pt = cache.get("page_table")
        if pt is None:
            max_len = ck.shape[2]
        else:
            if not per_row:
                raise ValueError("a paged cache needs a per-row [B] index")
            page = ck.shape[2]
            max_len = pt.shape[1] * page
            if self.seq_len is not None:
                max_len = min(max_len, self.seq_len + 1)
        if rotary is not None:
            if per_row:
                rot = rotary[_row_positions(index, n, rotary.shape[0])][:, None]  # [B, 1, n, d_rot]
            else:
                rot = rotary[index : index + n][None, None]  # [1, 1, n, d_rot]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        # int8 cache: quantize after rotary (the cache holds what attention
        # reads), per-(position, head) fp32 scales in sibling leaves; q
        # stays in the model dtype
        quant = "k_scale" in cache
        scales = (None, None)
        writes = [(ck, k), (cv, v)]
        if quant:
            k, k_sc = _kv_quantize(k)
            v, v_sc = _kv_quantize(v)
            scales = (cache["k_scale"], cache["v_scale"])
            writes = [(ck, k), (cv, v), (scales[0], k_sc), (scales[1], v_sc)]
        if pt is None:
            for buf, val in writes:
                _cache_write(buf, val, index)
        else:
            # the reference's per-position clamp (a finished row stepped
            # past the end rewrites its spare last position)
            pos = (index.to(torch.long)[:, None] + torch.arange(n, device=q.device)).clamp(
                max=max_len - 1
            )
            pages = torch.gather(pt.to(torch.long), 1, pos // page)
            for buf, val in writes:
                _paged_write(buf, val, pages, pos % page)
        # a policy bitmap ([B, nb] int32, nonzero = the KV block may be
        # read) supersedes the pattern masks on both arms and sends pattern
        # layers to the block-sparse kernel
        bitmap = cache.get("block_bitmap")
        sparse = bitmap is not None
        block = clamp_block_k(cache.get("sparse_block", DECODE_SPARSE_BLOCK), max_len)
        cache["index"] = index + n
        return dict(
            q=q, k=ck, v=cv, scales=scales, index=index,
            page_table=pt, paged_impl=cache.get("paged_impl"), max_len=max_len,
            bitmap=bitmap, block=block if sparse else None,
            flash=self.use_flash_decode(max_len, sparse=sparse),
        )

    def _read_dense(self, r: dict) -> torch.Tensor:
        """The dense arm of `read_cached` for this module's `write_cached`
        result: attention over the causal + pattern (or bitmap) mask."""
        q, ck, cv, scales, pt, max_len = r["q"], r["k"], r["v"], r["scales"], r["page_table"], r["max_len"]
        bitmap = r["bitmap"]
        index = r["index"]
        per_row = torch.is_tensor(index)
        n = q.shape[2]
        gk, gv, gscales = ck, cv, scales
        if pt is not None:
            gk, gv = paged_gather(ck, pt, max_len), paged_gather(cv, pt, max_len)
            if scales[0] is not None:
                gscales = tuple(paged_gather(t, pt, max_len) for t in scales)
        if scales[0] is not None:
            gk, gv = _kv_dequantize(gk, gscales[0]), _kv_dequantize(gv, gscales[1])
        offsets = torch.arange(n, device=q.device)
        qpos = index[:, None] + offsets if per_row else index + offsets  # [B, n] or [n]
        mask = torch.arange(max_len, device=q.device) <= qpos[..., None]
        mask = mask[:, None] if per_row else mask[None, None]  # [B or 1, 1, n, L]
        if bitmap is not None:
            mask = mask & expand_bitmap(bitmap, r["block"], max_len)[:, None, None, :]
        elif self.static_mask is not None:
            mask = mask & self._pattern_rows(index, n, max_len)
        return dense_attention(q, gk, gv, mask=mask, stable=self.stable).to(q.dtype)


def _lengths(r: dict) -> torch.Tensor:
    """The [B] int32 live lengths of a cached read: each row's index + n."""
    q, index = r["q"], r["index"]
    b, _, n, _ = q.shape
    if torch.is_tensor(index):
        return (index + n).to(torch.int32)
    return torch.full((b,), index + n, dtype=torch.int32, device=q.device)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """[B, H, n, D] -> [B, n, H * D]."""
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


def read_cached(attns, reads) -> list:
    """The cached read of one layer's shards (`attns[s]` the shard's
    module, `reads[s]` its `write_cached` result, heads split or whole):
    the flash arm through the sharded kernel wrappers, which launch each
    shard's kernel on its own heads (one shard: the unsplit launch); the
    dense arm per shard. Returns each shard's [B, n, heads_s * dim_head]."""
    r0 = reads[0]
    if not r0["flash"]:
        outs = [a._read_dense(r) for a, r in zip(attns, reads)]
    else:
        q = [r["q"].contiguous() for r in reads]
        k, v = [r["k"] for r in reads], [r["v"] for r in reads]
        lengths = [_lengths(r) for r in reads]
        scales = None if r0["scales"][0] is None else [r["scales"] for r in reads]
        k_scales = None if scales is None else [sc[0] for sc in scales]
        v_scales = None if scales is None else [sc[1] for sc in scales]
        bitmaps = None if r0["bitmap"] is None else [r["bitmap"] for r in reads]
        if r0["page_table"] is not None:
            outs = sharded_paged_decode_attention(
                q, k, v, lengths, [r["page_table"] for r in reads], r0["max_len"], r0["paged_impl"],
                k_scales, v_scales, block_bitmap=bitmaps, sparse_block=r0["block"],
            )
        else:
            outs = sharded_flash_decode_attention(
                q, k, v, lengths, k_scales, v_scales, block_bitmap=bitmaps, sparse_block=r0["block"]
            )
    return [_merge_heads(o) for o in outs]
