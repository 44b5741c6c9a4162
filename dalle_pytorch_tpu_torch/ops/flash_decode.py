"""Flash-decode attention: cached attention over a fixed-shape KV cache with
per-row live lengths — the wrapper of `csrc/flash_decode.cu` and its plain
PyTorch version.

Replaces the TPU kernel `dalle_pytorch_tpu/ops/pallas_decode.py:
_decode_kernel` (plain arm of `flash_decode_attention`). Function:

    out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] * scale) @ v[b, h, j]
                   over cache positions j <= lengths[b] - n + i

with `lengths` clipped to [0, S], fp32 accumulation whatever the input
type, output in q's dtype, no VJP (decode only). A row with no visible
key gives zeros (callers never produce one: lengths >= n).

On the card this is bound by bytes: a one-token decode step reads each
live K/V element once, 2*B*H*len*D*elt bytes per layer, and does 4*D
flops per element read. The kernel reads only live KV tiles (each block
loops to the last tile its rows can see) with 16-byte coalesced loads and
keeps the online softmax in fp32 registers; see the source's header for
what is left on the table (split-K at n = 1, tensor cores, TMA).

`flash_decode_attention` runs the kernel for CUDA tensors and the plain
version for CPU tensors — by the tensor's device alone, never as a
fallback. `flash_decode_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import torch

from dalle_pytorch_tpu_torch import kernels

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, lengths):
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
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q, k, v must share one dtype of {list(_DTYPE_CODE)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if len({t.device for t in (q, k, v, lengths)}) != 1:
        raise ValueError("q, k, v and lengths must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("q, k, v and lengths must be contiguous")


def flash_decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """The same function as a masked fp32 softmax over the whole cache."""
    b, h, n, d = q.shape
    s_len = k.shape[2]
    scale = d**-0.5
    lengths = lengths.to(torch.long).clamp(0, s_len)
    scores = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    bound = lengths[:, None] - n + torch.arange(n, device=q.device)[None, :]
    visible = torch.arange(s_len, device=q.device)[None, None, :] <= bound[:, :, None]
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # rows with no key
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l.clamp(min=1e-30)
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = kernels.library("flash_decode")
    fn = lib.flash_decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
    return lib


def flash_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """q [B, H, n, D], k/v [B, H, S, D] (float32 or bfloat16, contiguous,
    D in SUPPORTED_HEAD_DIMS), lengths [B] int32 -> [B, H, n, D].

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    `flash_decode_attention_plain`; anything else raises.
    """
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    b, h, n, d = q.shape
    s_len = k.shape[2]
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, n, s_len, d, _DTYPE_CODE[q.dtype], d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
