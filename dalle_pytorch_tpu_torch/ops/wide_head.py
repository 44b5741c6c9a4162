"""Attention at head dims above 256 on the card: the wrappers of
`csrc/wide_head.cu`, reached through the decode wrappers of
`ops/flash_decode.py` and the flash-attention wrappers of
`ops/flash_attention.py` when D > WIDE_ABOVE (their tuned kernels stop at
256). Each function here launches its kernel on the current stream and
counts the calls in `.launches`; its plain version is the calling
wrapper's, which takes any D. Nothing here runs on the CPU: the calling
wrappers run their plain versions for CPU tensors before reaching this
module.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dalle_pytorch_tpu_torch import kernels

WIDE_ABOVE = 256  # head dims above this run the kernels of this module
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = kernels.library("wide_head")
    if lib.wide_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wide_decode_launch.argtypes = [p] * 9 + [i] * 11 + [ctypes.c_float, p]
        lib.wide_attention_fwd.argtypes = [p] * 7 + [i] * 7 + [ctypes.c_float, p]
        lib.wide_attention_bwd.argtypes = [p] * 11 + [i] * 7 + [ctypes.c_float, p]
        for fn in (lib.wide_decode_launch, lib.wide_attention_fwd, lib.wide_attention_bwd):
            fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def wide_decode(q, k, v, lengths, k_scale=None, v_scale=None, block_bitmap=None, block_k=0,
                page_table=None) -> torch.Tensor:
    """The flash-decode function at any D (checked by the calling
    wrapper): the contiguous cache, or the pool read through `page_table`;
    `block_bitmap` over blocks of `block_k` positions (one per table entry
    when paged); int8 K/V with their scales."""
    b, h, n, d = q.shape
    paged = page_table is not None
    s_len = page_table.shape[1] * k.shape[2] if paged else k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _library().wide_decode_launch(
            _ptr(q), _ptr(k), _ptr(v), _ptr(k_scale), _ptr(v_scale), _ptr(lengths),
            _ptr(block_bitmap), _ptr(page_table), _ptr(out), b, h, n, s_len, d,
            0 if block_bitmap is None else block_bitmap.shape[1], int(block_k),
            k.shape[2] if paged else 0, k.shape[0] if paged else 0,
            _DTYPE_CODE[q.dtype], int(k_scale is not None), d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "wide_decode")
    wide_decode.launches += 1
    return out


def _masks(fm):
    return (None, None) if fm is None else (fm.mask.data_ptr(), fm.layout.data_ptr())


def wide_attention_fwd(q, k, v, mode: int, fm, scale: float):
    """(o, lse) of the flash-attention forward at any D; `mode` and the
    prepared mask `fm` as `ops/flash_attention.py` resolves them."""
    b, h, n_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().wide_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), *_masks(fm), _ptr(o), _ptr(lse),
            b, h, n_q, k.shape[2], d, _DTYPE_CODE[q.dtype], mode, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "wide_attention_fwd")
    wide_attention_fwd.launches += 1
    return o, lse


def wide_attention_bwd(q, k, v, do, lse, delta, mode: int, fm, scale: float):
    """(dq, dk, dv) of the flash-attention backward at any D (two kernels,
    dq and dk/dv, one call)."""
    b, h, n_q, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _library().wide_attention_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), *_masks(fm),
            _ptr(dq), _ptr(dk), _ptr(dv), b, h, n_q, k.shape[2], d, _DTYPE_CODE[q.dtype],
            mode, scale, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "wide_attention_bwd")
    wide_attention_bwd.launches += 1
    return dq, dk, dv


wide_decode.launches = 0
wide_attention_fwd.launches = 0
wide_attention_bwd.launches = 0
