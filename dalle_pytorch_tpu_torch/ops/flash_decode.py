"""Flash-decode attention: cached attention over a fixed-shape KV cache with
per-row live lengths — the wrappers of `csrc/flash_decode.cu` and their
plain PyTorch versions.

Replaces the TPU kernels of `dalle_pytorch_tpu/ops/pallas_decode.py`:
`_decode_kernel` (plain and int8 arms of `flash_decode_attention`) and
`_sparse_decode_kernel` (`block_sparse_flash_decode_attention`, both
arms). Function:

    out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] * scale) @ v[b, h, j]
                   over cache positions j <= lengths[b] - n + i
                   and, block-sparse, block_bitmap[b, j // block_k] != 0

with `lengths` clipped to [0, S], fp32 accumulation whatever the input
type, output in q's dtype, no VJP (decode only). A row with no visible
key gives zeros (callers never produce one: lengths >= n). An int8 cache
(`k_scale`/`v_scale` [B, H, S] float32, both or neither) is read as
`k_int8 * k_scale[..., None]` in fp32; q stays in the model dtype.

On the card this is bound by bytes: a one-token decode step reads each
live K/V element once, 2*B*H*len*D*elt bytes per layer (elt 1 for int8,
plus 8 bytes of scales per position), and does 4*D flops per element
read. The kernel splits the cache into spans of `DECODE_SPAN` positions
at the step (n <= `DECODE_ROWS`): one block per span of each (row, head),
the spans' partial softmax states merged in span order by the last block
to finish (`flash_decode_split_plain` is that arithmetic on the CPU). It
reads only the keys some row can see (length skip, dead blocks and pages
never read) with cp.async into a ring of shared-memory stages, splits each
tile's keys over its four warps and keeps K/V in their storage type until
registers; see the source's header. Head dims: any D, a cache never
padded per call. On the card D <= `MAX_KERNEL_HEAD_DIM` (256) runs the
kernels above and any larger D the kernels of `csrc/wide_head.cu`
(`ops/wide_head.py`): its split-K step up to DECODE_ROWS rows at any D
(the same spans and merge as here, so `flash_decode_split_plain` is its
arithmetic too), above that for bf16 q the tensor-core tile kernel of
`csrc/wide_decode_tile.cu` (the tile arm's arithmetic at any D, so
`flash_decode_tile_plain` is its model) and for fp32 q the register-tiled
`wide_decode_fma_kernel` of `csrc/wide_head.cu` (the fp32 tile arm's
arithmetic over 64-key tiles, so `flash_decode_tile_f32_plain` is its
model); each one body with runtime flags for the bitmap and the page
table, whose all-ones bitmap and paged layout give the plain contiguous
bits as here.

Paged cache (`_paged_decode_kernel`, `_sparse_paged_decode_kernel`):
K/V live in a pool [P, H, page, D] (int8 scales [P, H, page]) shared by
all rows, and row b's position j is at pool page page_table[b, j // page],
offset j % page. `paged_flash_decode_attention` and its block-sparse twin
(a bitmap of one bit per page-table entry) compute the function above on
that view, with S = n_pages * page; the kernels read only live pages
through the table, and a dead page's entry is never followed.
`paged_decode_attention` is the paged cache's dispatch (the reference's
of the same name): impl "gather" materializes the contiguous view with
`paged_gather` and runs the contiguous kernels (bit-identical to the
slotted cache), impl "kernel" runs the paged kernels (also bit-identical:
the same spans, tiles and summation order, see the source's header).
`None` takes `PAGED_DECODE_IMPL`, read from $DALLE_PAGED_DECODE_IMPL,
default "gather" as in the reference.

The prefill chunk and the resume forward (n > `DECODE_ROWS` query rows)
with bf16 q run the tile arm, `csrc/flash_decode_tile.cu`: flash
attention's forward over the cache, one block per 128 query rows looping
over 64-key tiles (`DECODE_TILE`) on bf16 tensor cores, P carried into
P V as a bf16 pair (hi, lo), int8 K/V widened to bf16 with the scales on
S's and P's columns, every variant (int8, block-sparse, paged) in one
body whose all-ones bitmap and paged layout give the plain contiguous
bits (`flash_decode_tile_plain` is its arithmetic on the CPU). fp32 q at
n > `DECODE_ROWS` runs the fp32 tile arm, `csrc/flash_decode_tile_f32.cu`:
one block per `DECODE_TILE_F32_ROWS` query rows over key tiles of
`tile_f32_keys(D)`, fp32 arithmetic on CUDA cores, int8 dequantized in
the kernel (`flash_decode_tile_f32_plain`; above 256 channels the model of
`wide_decode_fma_kernel` too). `decode_arm` is the dispatch rule.

`sharded_flash_decode_attention` and `sharded_paged_decode_attention`
(the reference's head-split wrappers) take one q, K/V and scale tensor per
shard of the heads and run the wrappers above on each shard: the outputs
joined by head are the unsharded call's bits.

Each wrapper runs the kernel for CUDA tensors and the plain version for
CPU tensors — by the tensor's device alone, never as a fallback. Launch
counts: `flash_decode_attention.launches` (plain arm) and
`.int8_launches`, the same pair on `block_sparse_flash_decode_attention`,
`paged_flash_decode_attention` and
`block_sparse_paged_flash_decode_attention`, each counting every launch
at D <= 256 whichever arm ran (calls at larger D count in
`wide_head.wide_decode.launches`); `.tile_launches` and
`.tile_int8_launches` count the ones of those that launched the tile arm,
`.tile_f32_launches` and `.tile_f32_int8_launches` the fp32 tile arm.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import torch

from dalle_pytorch_tpu_torch import kernels
from dalle_pytorch_tpu_torch.ops.wide_head import WIDE_ABOVE, split_scratch, wide_arm, wide_decode

MAX_KERNEL_HEAD_DIM = WIDE_ABOVE  # flash_decode.cu takes any D up to this (csrc dispatch_d)
DECODE_ROWS = 4  # query rows flash_decode.cu takes (csrc kRows); more run a tile arm
DECODE_SPAN = 128  # cache positions per split-K block (csrc kSpan, fixed from measurement)
DECODE_TILE = 64  # keys per tile of the tile arm (csrc/flash_decode_tile.cu kBN)
DECODE_TILE_F32_ROWS = 64  # query rows per block of the fp32 tile arm (csrc/flash_decode_tile_f32.cu kBM)
LOG2E = 1.4426950408889634  # the tile arm forms P in base 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PAGED_DECODE_IMPLS = ("gather", "kernel")
PAGED_DECODE_IMPL = os.environ.get("DALLE_PAGED_DECODE_IMPL", "gather")


def _check(q, k, v, lengths, k_scale=None, v_scale=None, page_table=None):
    """Shapes, dtypes, device and contiguity of a call; with `page_table`
    k/v (and the scales) are pools [P, H, page, D] and the table [B,
    n_pages] int32 of pool pages (its range checked here on the CPU; on
    the card the kernel traps on an entry out of range, as a check here
    would cost a host sync)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, n, D], got {tuple(q.shape)}")
    b, h, n, d = q.shape
    lead = (b, h) if page_table is None else (k.shape[0], h)
    if k.dim() != 4 or k.shape[:2] != lead or k.shape[3] != d or v.shape != k.shape:
        layout = "[B, H, S, D]" if page_table is None else "[P, H, page, D]"
        raise ValueError(
            f"k, v must be {layout} matching q {tuple(q.shape)}; got "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(
            f"lengths must be int32 [{b}], got {lengths.dtype} {tuple(lengths.shape)}"
        )
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be one of {list(_DTYPE_CODE)}, got {q.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    scales = () if k_scale is None else (k_scale, v_scale)
    if scales:
        if not (k.dtype == v.dtype == torch.int8):
            raise TypeError(f"a scaled cache must be int8, got {k.dtype}, {v.dtype}")
        for s in scales:
            if s.shape != k.shape[:3] or s.dtype != torch.float32:
                raise ValueError(
                    f"scales must be float32 {tuple(k.shape[:3])}, got {s.dtype} {tuple(s.shape)}"
                )
    elif not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k, v must share one dtype of {list(_DTYPE_CODE)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    tensors = (q, k, v, lengths) + scales
    if page_table is not None:
        if page_table.dim() != 2 or page_table.shape[0] != b or page_table.dtype != torch.int32:
            raise ValueError(
                f"page_table must be int32 [{b}, n_pages], got {page_table.dtype} "
                f"{tuple(page_table.shape)}"
            )
        if page_table.device.type == "cpu" and page_table.numel() and not (
            0 <= int(page_table.min()) and int(page_table.max()) < k.shape[0]
        ):
            raise ValueError(f"page_table entries must be pool pages in [0, {k.shape[0]})")
        tensors += (page_table,)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v, lengths, scales and page_table must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v, lengths, scales and page_table must be contiguous")


def clamp_block_k(block_k: int, s_len: int) -> int:
    """The bitmap's block width on a cache of `s_len` positions, clamped as
    the reference clamps it (tiny caches read as one block)."""
    return max(min(int(block_k), s_len), 1)


def _check_bitmap(block_bitmap, block_k, b, s_len, device):
    n_blocks = -(-s_len // block_k)
    if block_bitmap.shape != (b, n_blocks) or block_bitmap.dtype != torch.int32:
        raise ValueError(
            f"block_bitmap must be int32 [{b}, {n_blocks}] for S={s_len}, "
            f"block_k={block_k}; got {block_bitmap.dtype} {tuple(block_bitmap.shape)}"
        )
    if block_bitmap.device != device or not block_bitmap.is_contiguous():
        raise ValueError("block_bitmap must be contiguous and on q's device")


def _plain(q, k, v, lengths, k_scale, v_scale, kv_live=None):
    """Masked fp32 softmax over the whole cache; `kv_live` [B, S] bool
    additionally hides dead positions, whose values are never used (zeroed
    before the products, as the kernel never loads them)."""
    b, h, n, d = q.shape
    s_len = k.shape[2]
    scale = d**-0.5
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    if kv_live is not None:
        dead = ~kv_live[:, None, :, None]
        kf, vf = kf.masked_fill(dead, 0.0), vf.masked_fill(dead, 0.0)
    lengths = lengths.to(torch.long).clamp(0, s_len)
    scores = torch.matmul(q.float() * scale, kf.transpose(-1, -2))
    bound = lengths[:, None] - n + torch.arange(n, device=q.device)[None, :]
    visible = torch.arange(s_len, device=q.device)[None, None, :] <= bound[:, :, None]
    if kv_live is not None:
        visible = visible & kv_live[:, None, :]
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # rows with no key
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / l.clamp(min=1e-30)
    return out.to(q.dtype)


def flash_decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The same function as a masked fp32 softmax over the whole cache."""
    return _plain(q, k, v, lengths, k_scale, v_scale)


def flash_decode_split_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_bitmap: Optional[torch.Tensor] = None,
    block_k: Optional[int] = None,
    page_table: Optional[torch.Tensor] = None,
    span: int = DECODE_SPAN,
) -> torch.Tensor:
    """The kernels' split-K arithmetic in plain PyTorch (a model for tests;
    nothing on the main path calls it). For n <= DECODE_ROWS each span of
    `span` cache positions gets its own softmax state (m, l, acc): m the
    span's largest visible score (-inf when it has none), l and acc its
    sums of exp(s - m) and exp(s - m) v; the spans merge in span order,
    M = max m, out = sum(acc e^(m - M)) / sum(l e^(m - M)) over the spans
    with a visible key, zeros for a row with none. Larger n is one span.
    `block_bitmap` (with `block_k`) arms block sparsity; `page_table`
    reads k/v (and the scales) as pools [P, H, page, D] through it, the
    bitmap then one bit per page."""
    if page_table is not None:
        page = k.shape[2]
        vlen = page_table.shape[1] * page
        k, v, k_scale, v_scale = _gathered(k, v, page_table, vlen, k_scale, v_scale)
        block_k = page if block_bitmap is not None else block_k
    b, h, n, d = q.shape
    s_len = k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale[..., None], vf * v_scale[..., None]
    pos = torch.arange(s_len, device=q.device)
    bound = lengths.to(torch.long).clamp(0, s_len)[:, None] - n + torch.arange(n, device=q.device)
    visible = pos[None, None, :] <= bound[:, :, None]  # [B, n, S]
    if block_bitmap is not None:
        live = expand_bitmap(block_bitmap, clamp_block_k(block_k, s_len), s_len)
        visible = visible & live[:, None, :]
    scores = torch.matmul(q.float() * d**-0.5, kf.transpose(-1, -2))
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    vf = torch.where(visible.any(1)[:, None, :, None], vf, torch.zeros_like(vf))  # dead keys unread
    width = span if n <= DECODE_ROWS else s_len
    parts = []
    for lo in range(0, s_len, width):
        sc = scores[..., lo : lo + width]
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
        parts.append((m, p.sum(-1, keepdim=True), torch.matmul(p, vf[:, :, lo : lo + width])))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    safe_m = torch.where(torch.isfinite(big_m), big_m, torch.zeros_like(big_m))
    total_l = torch.zeros_like(big_m)
    total_acc = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:  # span order
        f = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
        total_l = total_l + l * f
        total_acc = total_acc + acc * f
    out = torch.where(total_l > 0, total_acc / total_l.clamp(min=1e-30), torch.zeros_like(total_acc))
    return out.to(q.dtype)


def flash_decode_tile_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_bitmap: Optional[torch.Tensor] = None,
    block_k: Optional[int] = None,
    page_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The tile arm's arithmetic in plain PyTorch (a model for tests;
    nothing on the main path calls it): an online softmax over tiles of
    DECODE_TILE cache positions in order. Per tile, S = q . k in fp32 (int8 K
    and V as their integer values), x = S * scale * log2(e) in fp32
    (int8: S's column j times k_scale[j] * scale * log2(e)), invisible
    scores -inf; m_new = max(m, max x), P = 2^(x - m_new) and the
    correction 2^(m - m_new) (a row whose maximum is still -inf takes 0
    in its place), l = l * corr + sum P, then acc = acc * corr + P V with
    P (int8: its column j times v_scale[j]) in bf16 as the pair hi =
    bf16(P), lo = bf16(P - hi), two products summed (`_p_operands`; fp32
    q keeps P as is).
    out = acc / l, zeros for a row with no visible key. Keys no row reads
    enter as zeros, as the kernel zero-fills them. `block_bitmap` (with
    `block_k`) arms block sparsity; `page_table` reads k/v (and the
    scales) as pools [P, H, page, D] through it, the bitmap then one bit
    per page."""
    return _online_tiles(q, k, v, lengths, k_scale, v_scale, block_bitmap, block_k, page_table,
                         DECODE_TILE, base2=True)


def flash_decode_tile_f32_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_bitmap: Optional[torch.Tensor] = None,
    block_k: Optional[int] = None,
    page_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fp32 tile arm's arithmetic (`csrc/flash_decode_tile_f32.cu`,
    fp32 q at n > DECODE_ROWS; above MAX_KERNEL_HEAD_DIM channels
    `wide_decode_fma_kernel` of csrc/wide_head.cu) in plain PyTorch, a
    model for tests that nothing on the main path calls: an online
    softmax over tiles of `tile_f32_keys(D)` cache positions in order,
    all in fp32 as the reference computes it. q is scaled by D^-0.5
    before the product, an int8 cache is dequantized first (k_int8 *
    k_scale, v_int8 * v_scale), S = q . k with invisible scores -inf;
    m_new = max(m, max S), P = e^(S - m_new) and the correction e^(m -
    m_new) (a row whose maximum is still -inf takes 0 in its place), l =
    l * corr + sum P, acc = acc * corr + P V. out = acc / l, zeros for a
    row with no visible key.
    Keys no row reads enter as zeros, as the kernel zero-fills them.
    `block_bitmap`, `block_k` and `page_table` as `flash_decode_tile_plain`."""
    return _online_tiles(q, k, v, lengths, k_scale, v_scale, block_bitmap, block_k, page_table,
                         tile_f32_keys(q.shape[3]), base2=False)


def _online_tiles(q, k, v, lengths, k_scale, v_scale, block_bitmap, block_k, page_table, tile, base2):
    """The two tile arms' online softmax over `tile`-key tiles: in base 2
    with S scaled after the product and P as `_p_operands` gives it
    (`base2`, the bf16 tile arm), else in base e over q scaled before the
    product and the dequantized cache (the fp32 tile arm)."""
    if page_table is not None:
        page = k.shape[2]
        vlen = page_table.shape[1] * page
        k, v, k_scale, v_scale = _gathered(k, v, page_table, vlen, k_scale, v_scale)
        block_k = page if block_bitmap is not None else block_k
    b, h, n, d = q.shape
    s_len = k.shape[2]
    pos = torch.arange(s_len, device=q.device)
    bound = lengths.to(torch.long).clamp(0, s_len)[:, None] - n + torch.arange(n, device=q.device)
    visible = pos[None, None, :] <= bound[:, :, None]  # [B, n, S]
    if block_bitmap is not None:
        live = expand_bitmap(block_bitmap, clamp_block_k(block_k, s_len), s_len)
        visible = visible & live[:, None, :]
    read = visible.any(1)[:, None, :]  # [B, 1, S]: the keys some row reads
    zero = torch.zeros((), device=q.device)
    kf, vf = k.float(), v.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    scale = torch.tensor(d**-0.5, **f32)
    qf, col, v_col = q.float(), None, None
    if base2:
        scale_log2 = scale * torch.tensor(LOG2E, **f32)  # fp32, as the kernel
        col = scale_log2.expand(b, h, s_len) if k_scale is None else torch.where(read, k_scale, zero) * scale_log2
        v_col = None if v_scale is None else torch.where(read, v_scale, zero)
        exp = torch.exp2
    else:
        qf = qf * scale
        if k_scale is not None:
            kf, vf = kf * k_scale[..., None], vf * v_scale[..., None]
        exp = torch.exp
    kf = torch.where(read[..., None], kf, zero)
    vf = torch.where(read[..., None], vf, zero)
    m = torch.full((b, h, n, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    for lo in range(0, s_len, tile):
        sl = slice(lo, lo + tile)
        x = torch.matmul(qf, kf[:, :, sl].transpose(-1, -2))
        if col is not None:
            x = x * col[:, :, None, sl]
        x = x.masked_fill(~visible[:, None, :, sl], float("-inf"))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), zero, m_new)
        corr = exp(m - m_use)
        p = exp(x - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        if v_col is not None:
            p = p * v_col[:, :, None, sl]
        operands = _p_operands(p, q.dtype) if base2 else (p,)
        acc = acc * corr + sum(torch.matmul(part, vf[:, :, sl]) for part in operands)
        m = m_new
    return torch.where(l > 0, acc / l.clamp(min=1e-30), zero).to(q.dtype)


def _p_operands(p: torch.Tensor, dtype: torch.dtype):
    """P as the tile arm's P V takes it: in bf16 the pair hi = bf16(P), lo =
    bf16(P - hi), whose two products sum into one fp32 accumulator (P to
    ~16 bits); in fp32 P itself."""
    if dtype != torch.bfloat16:
        return (p,)
    hi = p.to(dtype).float()
    return hi, (p - hi).to(dtype).float()


def tile_f32_keys(d: int) -> int:
    """Keys per tile of the fp32 multi-row kernel at head dim `d`: the fp32
    tile arm's (csrc/flash_decode_tile_f32.cu `tile_keys`) 64, and 32 above
    128 channels, where two stages of 64 fp32 keys pass the shared memory;
    above MAX_KERNEL_HEAD_DIM `wide_decode_fma_kernel`'s 64 (its ring holds
    channel slices of a tile)."""
    return 64 if d <= 128 or d > MAX_KERNEL_HEAD_DIM else 32


def expand_bitmap(block_bitmap: torch.Tensor, block_k: int, s_len: int) -> torch.Tensor:
    """[B, nb] block bitmap -> [B, S] bool per-position liveness."""
    return (block_bitmap != 0).repeat_interleave(block_k, dim=1)[:, :s_len]


def block_sparse_flash_decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    block_bitmap: torch.Tensor,
    block_k: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The block-sparse function: the plain version with the bitmap
    expanded to positions (an all-ones bitmap gives its exact bits)."""
    s_len = k.shape[2]
    kv_live = expand_bitmap(block_bitmap, clamp_block_k(block_k, s_len), s_len)
    return _plain(q, k, v, lengths, k_scale, v_scale, kv_live)


# the tile arms' sources, each with the same C interface (`<name>_launch`,
# `paged_<name>_launch`)
TILE_SOURCES = {"tile": "flash_decode_tile", "tile_f32": "flash_decode_tile_f32"}


def _tile_library(arm: str):
    """(contiguous, paged) launch functions of the tile arm `arm`."""
    name = TILE_SOURCES[arm]
    lib = kernels.library(name)
    fn, paged = getattr(lib, f"{name}_launch"), getattr(lib, f"paged_{name}_launch")
    if fn.argtypes is None:
        tail = [ctypes.c_float, ctypes.c_void_p]
        fn.restype = paged.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + tail
        paged.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + tail
    return fn, paged


def _library() -> ctypes.CDLL:
    lib = kernels.library("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        tail = [ctypes.c_float] + [ctypes.c_void_p] * 3
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + tail
        paged = lib.paged_flash_decode_launch
        paged.restype = ctypes.c_int
        paged.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + tail
        floats = lib.flash_decode_workspace_floats
        floats.restype = ctypes.c_longlong
        floats.argtypes = [ctypes.c_int] * 4
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_kernel_head_dim(d: int) -> None:
    """Raise unless `d` is a head dim (>= 1): the card takes every D, as
    the plain versions do (a cache is never padded per call)."""
    if d < 1:
        raise ValueError(f"head dim {d}: a head needs at least one channel")


def decode_kernel_source(d: int) -> str:
    """The source whose kernels take head dim `d` on the card:
    "flash_decode" up to MAX_KERNEL_HEAD_DIM (with its tile arms' sources
    above DECODE_ROWS rows), "wide_head" above (with csrc/wide_decode_tile.cu
    for bf16 q above DECODE_ROWS rows); `decode_arm` names the kernel."""
    check_kernel_head_dim(d)
    return "flash_decode" if d <= MAX_KERNEL_HEAD_DIM else "wide_head"


def decode_arm(n: int, dtype: torch.dtype, d: int) -> str:
    """The kernel a call of n query rows in q's `dtype` at head dim `d`
    launches on the card. Above MAX_KERNEL_HEAD_DIM (`wide_head.wide_arm`):
    csrc/wide_head.cu's split-K kernel ("wide_split", up to DECODE_ROWS
    rows); above DECODE_ROWS rows the tensor-core tile kernel of
    csrc/wide_decode_tile.cu for bf16 q ("wide_tile") and wide_head.cu's
    `wide_decode_fma_kernel` for fp32 q ("wide_tile_f32"); each at any D. Up to
    MAX_KERNEL_HEAD_DIM: flash_decode.cu's split-K
    instances at the step ("step", n = 1) and up to DECODE_ROWS rows
    ("split"); above DECODE_ROWS the tensor-core tile arm of
    flash_decode_tile.cu for bf16 q ("tile") and the CUDA-core tile arm
    of flash_decode_tile_f32.cu for fp32 q ("tile_f32")."""
    if d > MAX_KERNEL_HEAD_DIM:
        return wide_arm(n, dtype, d)
    if n == 1:
        return "step"
    if n <= DECODE_ROWS:
        return "split"
    return "tile" if dtype == torch.bfloat16 else "tile_f32"


def _count(fn, q, k_scale) -> None:
    """One launch of `fn`'s kernel (its int8 arm with scales), and of its
    tile arms where one ran; calls above MAX_KERNEL_HEAD_DIM launched
    `wide_decode` and count there."""
    b, h, n, d = q.shape
    arm = decode_arm(n, q.dtype, d)
    if arm.startswith("wide"):
        return
    if k_scale is None:
        fn.launches += 1
        fn.tile_launches += arm == "tile"
        fn.tile_f32_launches += arm == "tile_f32"
    else:
        fn.int8_launches += 1
        fn.tile_int8_launches += arm == "tile"
        fn.tile_f32_int8_launches += arm == "tile_f32"


def _launch(q, k, v, lengths, k_scale, v_scale, block_bitmap, block_k, page_table=None):
    """One launch of the contiguous (`page_table` None) or paged kernel;
    `block_bitmap` picks the block-sparse variant."""
    b, h, n, d = q.shape
    arm = decode_arm(n, q.dtype, d)
    if arm.startswith("wide"):
        return wide_decode(q, k, v, lengths, k_scale, v_scale, block_bitmap, block_k, page_table)
    tensors = [q, k, v] + ([] if k_scale is None else [k_scale, v_scale])
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k, v and scales must be 16-byte aligned")
    out = torch.empty_like(q)
    sparse = block_bitmap is not None
    quant = int(k_scale is not None)
    s_len = k.shape[2] if page_table is None else page_table.shape[1] * k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (_ptr(q), _ptr(k), _ptr(v), _ptr(k_scale), _ptr(v_scale), _ptr(lengths))
    if arm in TILE_SOURCES:
        contiguous, paged = _tile_library(arm)
        with torch.cuda.device(q.device):
            if page_table is None:
                err = contiguous(
                    *head, _ptr(block_bitmap), _ptr(out), b, h, n, s_len, d, quant,
                    block_k if sparse else 0, d**-0.5, stream,
                )
            else:
                err = paged(
                    *head, _ptr(page_table), _ptr(block_bitmap), _ptr(out), b, h, n,
                    k.shape[0], k.shape[2], page_table.shape[1], d, quant, d**-0.5, stream,
                )
        if err != 0:
            raise RuntimeError(f"{TILE_SOURCES[arm]} kernel launch failed: CUDA error {err}")
        return out
    lib = _library()
    workspace, counters = split_scratch(q.device, lib.flash_decode_workspace_floats(b, h, s_len, d), b * h)
    tail = (d**-0.5, stream, _ptr(workspace), _ptr(counters))
    with torch.cuda.device(q.device):
        if page_table is None:
            err = lib.flash_decode_launch(
                *head, _ptr(block_bitmap), _ptr(out), b, h, n, s_len, d,
                _DTYPE_CODE[q.dtype], quant,
                block_bitmap.shape[1] if sparse else 0, block_k if sparse else 0, *tail,
            )
        else:
            err = lib.paged_flash_decode_launch(
                *head, _ptr(page_table), _ptr(block_bitmap), _ptr(out), b, h, n,
                k.shape[0], k.shape[2], page_table.shape[1], d, _DTYPE_CODE[q.dtype], quant,
                *tail,
            )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    return out


def flash_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q [B, H, n, D] (float32 or bfloat16), k/v [B, H, S, D] in q's dtype
    or int8 with k_scale/v_scale [B, H, S] float32 (contiguous; any D), lengths [B] int32 -> [B, H, n,
    D] in q's dtype.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    `flash_decode_attention_plain`; anything else raises.
    """
    _check(q, k, v, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    out = _launch(q, k, v, lengths, k_scale, v_scale, None, 0)
    _count(flash_decode_attention, q, k_scale)
    return out


flash_decode_attention.launches = 0
flash_decode_attention.int8_launches = 0
flash_decode_attention.tile_launches = 0
flash_decode_attention.tile_int8_launches = 0
flash_decode_attention.tile_f32_launches = 0
flash_decode_attention.tile_f32_int8_launches = 0


def block_sparse_flash_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    block_bitmap: torch.Tensor,
    block_k: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`flash_decode_attention` that also hides the cache blocks whose
    `block_bitmap` entry is 0: block_bitmap [B, ceil(S / block_k)] int32,
    block j of row b covering positions [j*block_k, (j+1)*block_k), with
    block_k clamped to [1, S]. Within live blocks the causal-over-prefix
    mask still applies, so an all-ones bitmap gives exactly
    `flash_decode_attention`'s bits.

    CUDA tensors launch the kernel (dead tiles are neither read nor
    computed); CPU tensors run the plain version; anything else raises.
    """
    _check(q, k, v, lengths, k_scale, v_scale)
    s_len = k.shape[2]
    block_k = clamp_block_k(block_k, s_len)
    _check_bitmap(block_bitmap, block_k, q.shape[0], s_len, q.device)
    if q.device.type == "cpu":
        return block_sparse_flash_decode_attention_plain(
            q, k, v, lengths, block_bitmap, block_k, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_flash_decode_attention: unsupported device {q.device}")
    out = _launch(q, k, v, lengths, k_scale, v_scale, block_bitmap, block_k)
    _count(block_sparse_flash_decode_attention, q, k_scale)
    return out


block_sparse_flash_decode_attention.launches = 0
block_sparse_flash_decode_attention.int8_launches = 0
block_sparse_flash_decode_attention.tile_launches = 0
block_sparse_flash_decode_attention.tile_int8_launches = 0
block_sparse_flash_decode_attention.tile_f32_launches = 0
block_sparse_flash_decode_attention.tile_f32_int8_launches = 0


# ------------------------------------------------------------ paged cache


def paged_gather(pages: torch.Tensor, page_table: torch.Tensor, vlen: int) -> torch.Tensor:
    """Contiguous per-row view of a paged pool: pages [P, H, page, ...]
    (K/V with a trailing D, or scales without), page_table [B, n_pages]
    -> [B, H, vlen, ...], the first `vlen` positions of each row's
    logical sequence (positions no write reached come from whatever page
    the table names; callers mask them)."""
    b, n_pages = page_table.shape
    _, h, page = pages.shape[:3]
    g = pages[page_table.long()].transpose(1, 2)  # [B, H, n_pages, page, ...]
    g = g.reshape(b, h, n_pages * page, *pages.shape[3:])
    return g[:, :, :vlen].contiguous()


def _gathered(k_pages, v_pages, page_table, vlen, k_scale, v_scale):
    """(k, v, k_scale, v_scale) of the paged pool as contiguous caches."""
    k, v = (paged_gather(t, page_table, vlen) for t in (k_pages, v_pages))
    if k_scale is None:
        return k, v, None, None
    return k, v, paged_gather(k_scale, page_table, vlen), paged_gather(v_scale, page_table, vlen)


def paged_flash_decode_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_table: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The paged function as the plain version over the gathered view of
    all n_pages * page positions."""
    vlen = page_table.shape[1] * k_pages.shape[2]
    k, v, ks, vs = _gathered(k_pages, v_pages, page_table, vlen, k_scale, v_scale)
    return _plain(q, k, v, lengths, ks, vs)


def block_sparse_paged_flash_decode_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_table: torch.Tensor,
    block_bitmap: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The paged block-sparse function: the plain version over the
    gathered view with the page bitmap expanded to positions."""
    page = k_pages.shape[2]
    vlen = page_table.shape[1] * page
    k, v, ks, vs = _gathered(k_pages, v_pages, page_table, vlen, k_scale, v_scale)
    return _plain(q, k, v, lengths, ks, vs, expand_bitmap(block_bitmap, page, vlen))


def paged_flash_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_table: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q [B, H, n, D] (float32 or bfloat16) over the pool k_pages/v_pages
    [P, H, page, D] in q's dtype, or int8 with k_scale/v_scale [P, H,
    page] float32, read through page_table [B, n_pages] int32; lengths
    [B] int32, clipped to [0, n_pages * page] -> [B, H, n, D] in q's
    dtype.

    CUDA tensors launch the paged kernel (only live pages are read);
    CPU tensors run the plain version; anything else raises."""
    _check(q, k_pages, v_pages, lengths, k_scale, v_scale, page_table)
    if q.device.type == "cpu":
        return paged_flash_decode_attention_plain(
            q, k_pages, v_pages, lengths, page_table, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_attention: unsupported device {q.device}")
    out = _launch(q, k_pages, v_pages, lengths, k_scale, v_scale, None, 0, page_table)
    _count(paged_flash_decode_attention, q, k_scale)
    return out


paged_flash_decode_attention.launches = 0
paged_flash_decode_attention.int8_launches = 0
paged_flash_decode_attention.tile_launches = 0
paged_flash_decode_attention.tile_int8_launches = 0
paged_flash_decode_attention.tile_f32_launches = 0
paged_flash_decode_attention.tile_f32_int8_launches = 0


def block_sparse_paged_flash_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_table: torch.Tensor,
    block_bitmap: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`paged_flash_decode_attention` that also hides the pages whose
    `block_bitmap` entry is 0: block_bitmap [B, n_pages] int32, one bit
    per page-table entry. An all-ones bitmap gives exactly
    `paged_flash_decode_attention`'s bits.

    CUDA tensors launch the kernel (a dead page is never dereferenced);
    CPU tensors run the plain version; anything else raises."""
    _check(q, k_pages, v_pages, lengths, k_scale, v_scale, page_table)
    page = k_pages.shape[2]
    _check_bitmap(block_bitmap, page, q.shape[0], page_table.shape[1] * page, q.device)
    if q.device.type == "cpu":
        return block_sparse_paged_flash_decode_attention_plain(
            q, k_pages, v_pages, lengths, page_table, block_bitmap, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"block_sparse_paged_flash_decode_attention: unsupported device {q.device}"
        )
    out = _launch(q, k_pages, v_pages, lengths, k_scale, v_scale, block_bitmap, page, page_table)
    _count(block_sparse_paged_flash_decode_attention, q, k_scale)
    return out


block_sparse_paged_flash_decode_attention.launches = 0
block_sparse_paged_flash_decode_attention.int8_launches = 0
block_sparse_paged_flash_decode_attention.tile_launches = 0
block_sparse_paged_flash_decode_attention.tile_int8_launches = 0
block_sparse_paged_flash_decode_attention.tile_f32_launches = 0
block_sparse_paged_flash_decode_attention.tile_f32_int8_launches = 0


def page_bitmap(block_bitmap: torch.Tensor, sparse_block: int, page: int, n_pages: int) -> torch.Tensor:
    """A [B, nb] bitmap over blocks of `sparse_block` positions re-expanded
    to one bit per page ([B, n_pages] int32): `sparse_block` must be a
    multiple of `page`; pages past the bitmap's reach are dead."""
    if sparse_block % page:
        raise ValueError(
            f"sparse_block {sparse_block} must be a multiple of page_size {page} "
            "for the paged kernel"
        )
    b, nb = block_bitmap.shape
    r = sparse_block // page
    bm = block_bitmap[:, :, None].expand(b, nb, r).reshape(b, nb * r)
    if bm.shape[1] < n_pages:
        bm = torch.cat([bm, bm.new_zeros((b, n_pages - bm.shape[1]))], dim=1)
    return bm[:, :n_pages].contiguous()


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_table: torch.Tensor,
    vlen: int,
    impl: Optional[str] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_bitmap: Optional[torch.Tensor] = None,
    sparse_block: Optional[int] = None,
) -> torch.Tensor:
    """The paged cache's flash-decode dispatch. `vlen` is the virtual
    contiguous length the gather impl crops to (the slotted cache's
    max_len, so tiles match the slotted engine's exactly); `block_bitmap`
    ([B, ceil(vlen / sparse_block)] int32, with `sparse_block` the
    policy's block width, clamped to vlen as the slotted path clamps it)
    arms block sparsity.

    impl "gather": the contiguous (block-sparse) kernel on `paged_gather`
    views. impl "kernel": the paged kernels, the bitmap re-expanded to
    pages (`page_bitmap`). None: `PAGED_DECODE_IMPL`."""
    impl = PAGED_DECODE_IMPL if impl is None else impl
    if impl not in PAGED_DECODE_IMPLS:
        raise ValueError(f"paged decode impl {impl!r} not in {PAGED_DECODE_IMPLS}")
    if block_bitmap is not None and sparse_block is None:
        raise ValueError("sparse_block rides block_bitmap")
    if impl == "gather":
        k, v, ks, vs = _gathered(k_pages, v_pages, page_table, vlen, k_scale, v_scale)
        if block_bitmap is not None:
            return block_sparse_flash_decode_attention(
                q, k, v, lengths, block_bitmap, sparse_block, ks, vs
            )
        return flash_decode_attention(q, k, v, lengths, ks, vs)
    if block_bitmap is not None:
        bm = page_bitmap(block_bitmap, sparse_block, k_pages.shape[2], page_table.shape[1])
        return block_sparse_paged_flash_decode_attention(
            q, k_pages, v_pages, lengths, page_table, bm, k_scale, v_scale
        )
    return paged_flash_decode_attention(q, k_pages, v_pages, lengths, page_table, k_scale, v_scale)


# ------------------------------------------------------ head-split shards


def _shard_arg(arg, s: int, device):
    """Shard s's copy of an argument given once for all shards (a tensor,
    put on the shard's device) or as one per shard (a list)."""
    if arg is None:
        return None
    if isinstance(arg, (list, tuple)):
        return arg[s]
    return arg.to(device)


def sharded_flash_decode_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    lengths,
    k_scales: Optional[Sequence[torch.Tensor]] = None,
    v_scales: Optional[Sequence[torch.Tensor]] = None,
    block_bitmap=None,
    sparse_block: Optional[int] = None,
) -> List[torch.Tensor]:
    """`flash_decode_attention` over shards split by head (the reference's
    `sharded_flash_decode_attention`): qs/ks/vs and the int8 scales are one
    tensor per shard, each shard's slice of the heads on its own device;
    `lengths` and `block_bitmap` (with `sparse_block`, for
    `block_sparse_flash_decode_attention`) are the same for every shard,
    given once or one per shard. Each shard runs the unchanged wrapper on
    its heads, so the outputs joined by head are the unsharded call's bits.
    A shard holding every head (a head count the axis does not divide) runs
    the unsplit kernel. Returns one output per shard."""
    outs = []
    for s, (q, k, v) in enumerate(zip(qs, ks, vs)):
        lens = _shard_arg(lengths, s, q.device)
        ksc, vsc = _shard_arg(k_scales, s, q.device), _shard_arg(v_scales, s, q.device)
        if block_bitmap is None:
            outs.append(flash_decode_attention(q, k, v, lens, ksc, vsc))
        else:
            bm = _shard_arg(block_bitmap, s, q.device)
            outs.append(block_sparse_flash_decode_attention(q, k, v, lens, bm, sparse_block, ksc, vsc))
    return outs


def sharded_paged_decode_attention(
    qs: Sequence[torch.Tensor],
    k_pages: Sequence[torch.Tensor],
    v_pages: Sequence[torch.Tensor],
    lengths,
    page_table,
    vlen: int,
    impl: Optional[str] = None,
    k_scales: Optional[Sequence[torch.Tensor]] = None,
    v_scales: Optional[Sequence[torch.Tensor]] = None,
    block_bitmap=None,
    sparse_block: Optional[int] = None,
) -> List[torch.Tensor]:
    """`paged_decode_attention` over shards split by head (the reference's
    `sharded_paged_decode_attention`): each shard's pool holds its heads of
    every page, and the page table, lengths and bitmap are the same on
    every shard (pages never split: the table addresses them globally).
    Each shard runs the unchanged dispatch on its heads. Returns one output
    per shard."""
    outs = []
    for s, (q, kp, vp) in enumerate(zip(qs, k_pages, v_pages)):
        dev = q.device
        outs.append(paged_decode_attention(
            q, kp, vp, _shard_arg(lengths, s, dev), _shard_arg(page_table, s, dev), vlen, impl,
            _shard_arg(k_scales, s, dev), _shard_arg(v_scales, s, dev),
            block_bitmap=_shard_arg(block_bitmap, s, dev), sparse_block=sparse_block,
        ))
    return outs
