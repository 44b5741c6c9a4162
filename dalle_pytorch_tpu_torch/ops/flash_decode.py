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
read. The kernel reads only live KV tiles (each block loops to the last
tile its rows can see, and skips tiles the bitmap leaves dead) with
16-byte coalesced loads, dequantizes int8 into shared memory and keeps
the online softmax in fp32 registers; see the source's header for what is
left on the table (split-K at n = 1, tensor cores, TMA).

Each wrapper runs the kernel for CUDA tensors and the plain version for
CPU tensors — by the tensor's device alone, never as a fallback. Launch
counts: `flash_decode_attention.launches` (plain arm) and
`.int8_launches`, the same pair on `block_sparse_flash_decode_attention`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dalle_pytorch_tpu_torch import kernels

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, lengths, k_scale=None, v_scale=None):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, n, D], got {tuple(q.shape)}")
    b, h, n, d = q.shape
    if k.dim() != 4 or k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"k, v must be [B, H, S, D] matching q {tuple(q.shape)}; got "
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
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    tensors = (q, k, v, lengths) + scales
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v, lengths and scales must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v, lengths and scales must be contiguous")


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


def _library() -> ctypes.CDLL:
    lib = kernels.library("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
    return lib


def _launch(q, k, v, lengths, k_scale, v_scale, block_bitmap, block_k):
    b, h, n, d = q.shape
    s_len = k.shape[2]
    tensors = [q, k, v] + ([] if k_scale is None else [k_scale, v_scale])
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k, v and scales must be 16-byte aligned")
    lib = _library()
    out = torch.empty_like(q)
    sparse = block_bitmap is not None
    with torch.cuda.device(q.device):
        err = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            lengths.data_ptr(),
            block_bitmap.data_ptr() if sparse else None,
            out.data_ptr(), b, h, n, s_len, d, _DTYPE_CODE[q.dtype],
            int(k_scale is not None),
            block_bitmap.shape[1] if sparse else 0,
            block_k if sparse else 0,
            d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
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
    or int8 with k_scale/v_scale [B, H, S] float32 (contiguous, D in
    SUPPORTED_HEAD_DIMS), lengths [B] int32 -> [B, H, n, D] in q's dtype.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    `flash_decode_attention_plain`; anything else raises.
    """
    _check(q, k, v, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    out = _launch(q, k, v, lengths, k_scale, v_scale, None, 0)
    if k_scale is None:
        flash_decode_attention.launches += 1
    else:
        flash_decode_attention.int8_launches += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.int8_launches = 0


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
    if k_scale is None:
        block_sparse_flash_decode_attention.launches += 1
    else:
        block_sparse_flash_decode_attention.int8_launches += 1
    return out


block_sparse_flash_decode_attention.launches = 0
block_sparse_flash_decode_attention.int8_launches = 0
