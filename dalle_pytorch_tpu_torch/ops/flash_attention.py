"""Flash attention for training: the wrappers of `csrc/flash_attention.cu`
(forward; backward), their plain PyTorch versions, and the differentiable
`flash_attention` built from them.

Replaces the TPU kernels of the JAX package's `ops/pallas_attention.py`:
`_fwd_kernel` (`_flash_forward`), `_dq_kernel` and `_dkv_kernel`
(`_flash_backward`), and the custom VJP of its `flash_attention`. Layout
[B, H, N, D] as there. Functions, with s = q . k^T * scale:

    forward:   o = softmax(s) v,  lse = logsumexp(s)        -> (o, lse)
    backward:  p = exp(s - lse), ds = p (do . v^T - delta) scale,
               dq = ds k,  dk = ds^T q,  dv = p^T do        -> (dq, dk, dv)

over the visible (query, key) pairs of one of three arms: all keys; causal
(key <= query in global indices, the reference's top-left convention, also
when n_k != n_q); or a static [n_q, n_k] bool mask, which the kernels read
with a [ceil(n_q/64), ceil(n_k/64)] tile layout so empty tiles are skipped
(`mask_block_layout` at the kernels' 64 x 64 tiles, not the TPU's 128).
Masked scores take the finite -1e30 as in the reference; every query row
must see a key. delta = rowsum(do * o) is computed in float32 outside the
kernels, as the reference does. Accumulation is float32 whatever the input
type (float32 or bfloat16); o, dq, dk, dv come out in the input type, lse
in float32 [B, H, n_q]. On the card, bfloat16 inputs run on tensor cores
and round P and dS to bfloat16 before their second products, as
FlashAttention does (dS once, for both dk and dq); in float32 (D <= 256)
the forward and the backward form each product as three TF32 tensor-core
products of operands split into TF32 (hi, lo) pairs, ~21 of float32's 24
bits (`flash_attention_forward_tf32x3_plain` and
`flash_attention_bwd_tf32x3_plain` are that arithmetic; the card holds the
kernels to the exact plain version). The plain versions round P and dS only when
asked (`p_dtype`): then they form and round them as the tensor-core
kernels do, the forward's P per 64-key tile against the running row
maximum and in base 2, 2^(fl(s scale log2(e)) - m), as the bfloat16
forward kernel does, so a kernel can be held to its own rounding and not
only to the exact function.

Any head dim: the plain versions take any D, as the reference does. The
kernels have instances at D = 16, 32, 64, 128 and 256, the bfloat16
forward at 64, 128 and 256 only; on the card a D <= 256 between them is
zero-padded along D to the kernel's next instance, run with the true D's
scale (D ** -0.5 unless `sm_scale`), and cut back (`on_kernel_head_dim`):
zero columns add nothing to q . k and give zero output columns, so lse is
unchanged. D > 256 runs on the column-group kernels of
`csrc/wide_head.cu` (`ops/wide_head.py`: each block owns some of the
output columns and loops the scores over all of D in 64-channel chunks,
so no D runs out of registers or shared memory; bfloat16 on tensor cores
with the rounding described here, float32 on CUDA cores).
`attention_kernels(D, dtype)` names the kernels a call launches.

On the card the kernels are bound by operations at the training shapes:
4 D flops per visible pair forward, 10 D backward (S and dP once, then
dV, dK and dQ). The bfloat16 forward runs on wgmma. The bfloat16
backward is one fused kernel
(FlashAttention-2's one pass: a block per key tile loops over the query
tiles, dq added into a float32 workspace with atomics, so dq's last bits
may change from run to run while dk and dv are bit-identical); the float32
forward is one tensor-core pass and the float32 backward two, dq and dk/dv,
with no atomics (see the source's header).
Each wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors, by the tensor's device alone, never as a fallback, and counts
passes launched on the card in `.launches` (D <= 256; calls at larger D
count in `wide_head.wide_attention_fwd/bwd.launches`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from dalle_pytorch_tpu_torch import kernels
from dalle_pytorch_tpu_torch.ops.masks import mask_block_layout
from dalle_pytorch_tpu_torch.ops.wide_head import (
    WIDE_ABOVE,
    wide_attention_bwd,
    wide_attention_fwd,
    wide_attention_kernels,
    wide_kernel_head_dim,
)

BLOCK = 64  # the kernels' query and key tile (csrc/flash_attention.cu kBlock)
KERNEL_HEAD_DIMS = (16, 32, 64, 128, WIDE_ABOVE)  # the instances; other D <= 256 pad up
WGMMA_HEAD_DIMS = (64, 128, 256)  # the bfloat16 forward's (whole 64-column panels)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MODE_ALL, MODE_CAUSAL, MODE_MASK = 0, 1, 2


@dataclass(frozen=True)
class FlashMask:
    """A static mask prepared for the kernels: the bool token mask
    [n_q, n_k] and its int32 tile layout, both on the device of use."""

    mask: torch.Tensor
    layout: torch.Tensor


def flash_mask(mask: np.ndarray, device=None) -> FlashMask:
    """Analyse a host bool mask (True = attend) once, for repeated calls;
    raises on a fully masked query row."""
    mask = np.asarray(mask, dtype=bool)
    _, layout = mask_block_layout(mask, BLOCK, BLOCK)
    return FlashMask(
        torch.tensor(mask, device=device), torch.tensor(layout, device=device)
    )


MaskLike = Union[None, np.ndarray, FlashMask]


def _resolve(mask: MaskLike, causal: bool, q: torch.Tensor, k: torch.Tensor):
    """(mode, FlashMask or None). A mask replaces the causal rule, as in
    the reference (callers compose causality into it)."""
    if mask is None:
        return (MODE_CAUSAL if causal else MODE_ALL), None
    fm = mask if isinstance(mask, FlashMask) else flash_mask(mask, q.device)
    n_q, n_k = q.shape[2], k.shape[2]
    nt = (-(-n_q // BLOCK), -(-n_k // BLOCK))
    if tuple(fm.mask.shape) != (n_q, n_k) or fm.mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{n_q}, {n_k}], got {fm.mask.dtype} {tuple(fm.mask.shape)}")
    if tuple(fm.layout.shape) != nt or fm.layout.dtype != torch.int32:
        raise ValueError(f"layout must be int32 {list(nt)}, got {fm.layout.dtype} {tuple(fm.layout.shape)}")
    if fm.mask.device != q.device or fm.layout.device != q.device:
        raise ValueError(f"mask on {fm.mask.device}, tensors on {q.device}")
    if not (fm.mask.is_contiguous() and fm.layout.is_contiguous()):
        raise ValueError("mask and layout must be contiguous")
    return MODE_MASK, fm


def _check(q, k, v, *extra):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, D], got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if k.dim() != 4 or k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"k, v must be [B, H, N_k, D] matching q {tuple(q.shape)}; got "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q, k, v must share one dtype of {list(_DTYPE_CODE)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    tensors = (q, k, v, *extra)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")


def _check_backward(q, do, lse, delta):
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {do.dtype} {tuple(do.shape)}")
    rows = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != rows or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(rows)}, got {t.dtype} {tuple(t.shape)}")


def _scale(q, sm_scale):
    return q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)


def _visible(mode, fm, n_q, n_k, device) -> Optional[torch.Tensor]:
    if mode == MODE_MASK:
        return fm.mask
    if mode == MODE_CAUSAL:
        rows = torch.arange(n_q, device=device)[:, None]
        return torch.arange(n_k, device=device)[None, :] <= rows
    return None


# ---------------------------------------------------------------- plain


def _rounded(x: torch.Tensor, p_dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if p_dtype is None else x.to(p_dtype).float()


def _running_tile_max(s: torch.Tensor) -> torch.Tensor:
    """[..., n_q, n_k] -> each score's running row maximum through its
    BLOCK-wide key tile: the m the kernel's online softmax holds there."""
    n_k = s.shape[-1]
    tiles = F.pad(s, (0, (-n_k) % BLOCK), value=NEG_INF).unflatten(-1, (-1, BLOCK))
    running = torch.cummax(tiles.amax(dim=-1), dim=-1).values
    return running.repeat_interleave(BLOCK, dim=-1)[..., :n_k]


def flash_attention_forward_plain(
    q, k, v, mask: MaskLike = None, causal=True, sm_scale=None, *, p_dtype=None
):
    """The forward as one masked float32 softmax: (o in q's dtype, lse
    float32 [B, H, n_q]). With `p_dtype`, P enters P . V rounded to it as
    the bfloat16 kernel forms it, in base 2: with x = fl(q . k^T
    fl(scale log2(e))), 2^(x - m_t) per key tile t, m_t the running row
    maximum of x through t, then rescaled by 2^(m_t - m); l and lse stay
    the exact function's (the kernel's base-2 l differs by float32
    rounding only)."""
    mode, fm = _resolve(mask, causal, q, k)
    scale = _scale(q, sm_scale)
    with torch.autocast(q.device.type, enabled=False):
        qk = torch.matmul(q.float(), k.float().transpose(-1, -2))
        s = qk * scale
        keep = _visible(mode, fm, q.shape[2], k.shape[2], q.device)
        if keep is not None:
            s = s.masked_fill(~keep, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        safe_l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        if p_dtype is not None:
            x = qk * float(np.float32(scale) * np.float32(LOG2E))
            if keep is not None:
                x = x.masked_fill(~keep, NEG_INF)
            m_x, m_t = x.amax(dim=-1, keepdim=True), _running_tile_max(x)
            p = _rounded(torch.exp2(x - m_t), p_dtype) * torch.exp2(m_t - m_x)
        o = torch.matmul(p, v.float()) / safe_l
        lse = (m + torch.log(safe_l))[..., 0]
    return o.to(q.dtype), lse


def _probs_and_ds(q, k, v, do, lse, delta, mode, fm, scale, matmul=torch.matmul):
    """float32 p = exp(s - lse) over visible pairs and ds = p (dp - delta) scale."""
    s = matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    keep = _visible(mode, fm, q.shape[2], k.shape[2], q.device)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_dq_plain(
    q, k, v, do, lse, delta, mask: MaskLike = None, causal=True, sm_scale=None, *, p_dtype=None
):
    """dq in q's dtype, from the saved lse and delta = rowsum(do * o);
    with `p_dtype`, dS enters dS . K rounded to it."""
    mode, fm = _resolve(mask, causal, q, k)
    with torch.autocast(q.device.type, enabled=False):
        _, ds = _probs_and_ds(q, k, v, do, lse, delta, mode, fm, _scale(q, sm_scale))
        dq = torch.matmul(_rounded(ds, p_dtype), k.float())
    return dq.to(q.dtype)


def flash_attention_dkv_plain(
    q, k, v, do, lse, delta, mask: MaskLike = None, causal=True, sm_scale=None, *, p_dtype=None
):
    """(dk, dv) in k's dtype; with `p_dtype`, P and dS enter their second
    products rounded to it."""
    mode, fm = _resolve(mask, causal, q, k)
    with torch.autocast(q.device.type, enabled=False):
        p, ds = _probs_and_ds(q, k, v, do, lse, delta, mode, fm, _scale(q, sm_scale))
        dv = torch.matmul(_rounded(p, p_dtype).transpose(-1, -2), do.float())
        dk = torch.matmul(_rounded(ds, p_dtype).transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(k.dtype)


def flash_attention_bwd_plain(
    q, k, v, do, lse, delta, mask: MaskLike = None, causal=True, sm_scale=None, *, p_dtype=None
):
    """(dq, dk, dv) in the inputs' dtype, P and dS formed once; with
    `p_dtype`, P and dS enter their second products rounded to it, dS
    rounded once for both dq and dk, as the fused kernel does."""
    mode, fm = _resolve(mask, causal, q, k)
    with torch.autocast(q.device.type, enabled=False):
        p, ds = _probs_and_ds(q, k, v, do, lse, delta, mode, fm, _scale(q, sm_scale))
        p, ds = _rounded(p, p_dtype), _rounded(ds, p_dtype)
        dq = torch.matmul(ds, k.float())
        dk = torch.matmul(ds.transpose(-1, -2), q.float())
        dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(k.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as `cvt.rna.tf32.f32` rounds: half a unit of the
    13 dropped bits added to the magnitude, then those bits cleared (a
    carry into the exponent is the correct rounding; past the largest TF32
    it gives infinity); infinities and NaN pass through."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def split_tf32(x: torch.Tensor):
    """(hi, lo): TF32 values with hi = round_tf32(x), lo = round_tf32(x - hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the float32 backward's kernels form it: each operand split
    into TF32 (hi, lo), three exact products lo.hi + hi.lo + hi.hi summed
    in float32, the small terms first (the products of two TF32 values are
    exact in float32, so with float32 sums this is the split's arithmetic
    up to summation order)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def flash_attention_forward_tf32x3_plain(q, k, v, mask: MaskLike = None, causal=True, sm_scale=None):
    """(o, lse) in float32 as the float32 forward kernel computes them: S
    = Q K^T by three TF32 products (`tf32x3_matmul`), P in base 2 per
    BLOCK-wide key tile, 2^(fl(S fl(scale log2(e))) - m_t) with m_t the
    running row maximum through tile t (masked P 0), each tile's P V by
    three TF32 products from P's float32 values, the tiles' partials
    rescaled by 2^(m_t - m) to the final maximum m and summed; l likewise,
    lse = m ln(2) + log(l). A model of the kernel's arithmetic (the sums in
    another order) for tests and the card's checks; no caller's path runs
    it."""
    mode, fm = _resolve(mask, causal, q, k)
    scale = _scale(q, sm_scale)
    with torch.autocast(q.device.type, enabled=False):
        x = tf32x3_matmul(q.float(), k.float().transpose(-1, -2)) * float(np.float32(scale) * np.float32(LOG2E))
        keep = _visible(mode, fm, q.shape[2], k.shape[2], q.device)
        if keep is not None:
            x = x.masked_fill(~keep, NEG_INF)
        m_t = _running_tile_max(x)
        p = torch.exp2(x - m_t)
        if keep is not None:
            p = p.masked_fill(~keep, 0.0)
        m = x.amax(dim=-1, keepdim=True)
        pad = (-k.shape[2]) % BLOCK
        weight = torch.exp2(m_t[..., ::BLOCK] - m)  # [B, H, n_q, tiles]
        tiles = F.pad(p, (0, pad)).unflatten(-1, (-1, BLOCK)).movedim(-2, -3)  # [B, H, tiles, n_q, BLOCK]
        v_tiles = F.pad(v.float(), (0, 0, 0, pad)).unflatten(-2, (-1, BLOCK))  # [B, H, tiles, BLOCK, D]
        partials = tf32x3_matmul(tiles, v_tiles) * weight.movedim(-1, -2)[..., None]
        safe_l = (p * torch.exp2(m_t - m)).sum(dim=-1, keepdim=True).clamp(min=1e-30)
        o = partials.sum(dim=-3) / safe_l
        lse = (m * LN2 + torch.log(safe_l))[..., 0]
    return o, lse


def flash_attention_bwd_tf32x3_plain(
    q, k, v, do, lse, delta, mask: MaskLike = None, causal=True, sm_scale=None
):
    """(dq, dk, dv) in float32 as the float32 backward's kernels compute
    them: `flash_attention_bwd_plain` with every product (S, dP, dq, dk,
    dv) in three TF32 products (`tf32x3_matmul`), P and dS split from their
    float32 values. A model of the kernels' arithmetic for tests and the
    card's checks; no caller's path runs it."""
    mode, fm = _resolve(mask, causal, q, k)
    with torch.autocast(q.device.type, enabled=False):
        p, ds = _probs_and_ds(q, k, v, do, lse, delta, mode, fm, _scale(q, sm_scale), tf32x3_matmul)
        dq = tf32x3_matmul(ds, k.float())
        dk = tf32x3_matmul(ds.transpose(-1, -2), q.float())
        dv = tf32x3_matmul(p.transpose(-1, -2), do.float())
    return dq, dk, dv


# ---------------------------------------------------------------- kernels


def _library() -> ctypes.CDLL:
    lib = kernels.library("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        ints = [ctypes.c_int] * 7  # B, H, nq, nk, D, dtype, mode
        tail = ints + [ctypes.c_float, ctypes.c_void_p]
        for name, n_ptr in (("flash_attention_fwd", 7), ("flash_attention_bwd", 12)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
    return lib


def kernel_head_dim(d: int, dims=KERNEL_HEAD_DIMS) -> int:
    """The kernel's head dim for a true head dim `d`: the next of its
    instances `dims`; above the last (256), `d` itself (the wide kernels
    take any D unpadded)."""
    return next((kd for kd in dims if d <= kd), d)


def attention_kernel_source(d: int) -> str:
    """The source whose kernels a call at head dim `d` launches on the
    card: "flash_attention" up to 256, "wide_head" above."""
    return "flash_attention" if d <= WIDE_ABOVE else "wide_head"


def attention_kernels(d: int, dtype: torch.dtype) -> dict:
    """{"fwd": kernel, "bwd": (kernels...)}: the kernels a call at head dim
    `d` and `dtype` launches on the card, as a profiler trace names them
    (the bfloat16 backward's workspace memset and dq conversion aside)."""
    if attention_kernel_source(d) == "wide_head":
        return wide_attention_kernels(d, dtype)
    if dtype == torch.bfloat16:
        return {"fwd": f"fwd_wgmma_kernel<{kernel_head_dim(d, WGMMA_HEAD_DIMS)}>",
                "bwd": (f"bwd_mma_kernel<{kernel_head_dim(d)}>",)}
    if dtype == torch.float32:
        kd = kernel_head_dim(d)
        return {"fwd": f"fwd_tf32_kernel<{kd}>", "bwd": (f"dq_tf32_kernel<{kd}>", f"dkv_tf32_kernel<{kd}>")}
    raise TypeError(f"no flash-attention kernel for {dtype}")


def on_kernel_head_dim(fn, tensors, n_sliced: int, sm_scale=None, dims=KERNEL_HEAD_DIMS):
    """fn(*padded, scale): `tensors` ([..., D] each) zero-padded along D to
    `kernel_head_dim(D, dims)`, scale the true D's (D ** -0.5 unless
    `sm_scale`); the first `n_sliced` outputs are cut back to D. Zero
    columns add nothing to q . k, and zero V columns give zero output
    columns, so this is the unpadded function; lse and the rest pass
    through."""
    d = tensors[0].shape[-1]
    dk = kernel_head_dim(d, dims)
    scale = _scale(tensors[0], sm_scale)
    if dk == d:
        return fn(*tensors, scale)
    out = fn(*(F.pad(t, (0, dk - d)) for t in tensors), scale)
    return tuple(o[..., :d].contiguous() if i < n_sliced else o for i, o in enumerate(out))


def _launch(name, q, k, ins, outs, mode, fm, scale):
    """Call csrc entry `name`: pointers of `ins`, the mask and layout (null
    unless the mask arm), pointers of `outs` (None passes null), then the
    sizes."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t is not None and t.data_ptr() % 16 for t in (*ins, *outs)):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    lib = _library()
    b, h, n_q, d = q.shape
    masks = (fm.mask.data_ptr(), fm.layout.data_ptr()) if mode == MODE_MASK else (None, None)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            *(t.data_ptr() for t in ins), *masks,
            *(None if t is None else t.data_ptr() for t in outs),
            b, h, n_q, k.shape[2], d, _DTYPE_CODE[q.dtype], mode, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_attention_fwd(q, k, v, mask: MaskLike = None, causal=True, sm_scale=None):
    """(o, lse) of the forward. CUDA tensors launch the kernel on the
    current stream (D <= 256 padded to the kernel's head dim by
    `on_kernel_head_dim`: 64, 128 or 256 in bfloat16; larger D on the
    wide kernel); CPU tensors run `flash_attention_forward_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v, mask, causal, sm_scale)
    mode, fm = _resolve(mask, causal, q, k)
    d = q.shape[-1]
    if attention_kernel_source(d) == "wide_head":
        return on_kernel_head_dim(
            lambda q, k, v, scale: wide_attention_fwd(q, k, v, mode, fm, scale), (q, k, v), 1,
            sm_scale, (wide_kernel_head_dim(d, q.dtype),))

    def launch(q, k, v, scale):
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        _launch("flash_attention_fwd", q, k, (q, k, v), (o, lse), mode, fm, scale)
        return o, lse

    dims = WGMMA_HEAD_DIMS if q.dtype == torch.bfloat16 else KERNEL_HEAD_DIMS
    o, lse = on_kernel_head_dim(launch, (q, k, v), 1, sm_scale, dims)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, do, lse, delta, mask: MaskLike = None, causal=True, sm_scale=None):
    """(dq, dk, dv) of the backward, from the forward's lse and delta =
    rowsum(do * o). CUDA tensors (D > 256 on the wide kernels, smaller D
    padded to the next of KERNEL_HEAD_DIMS):
    bfloat16 launches the fused kernel (between zeroing a float32 [B, H,
    n_q, D] dq workspace, allocated here, and converting it into dq),
    float32 the two TF32 tensor-core passes (dq, then dk and dv); CPU
    tensors run `flash_attention_bwd_plain`."""
    _check(q, k, v, do, lse, delta)
    _check_backward(q, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, mask, causal, sm_scale)
    mode, fm = _resolve(mask, causal, q, k)
    d = q.shape[-1]
    if attention_kernel_source(d) == "wide_head":
        return on_kernel_head_dim(
            lambda q, k, v, do, scale: wide_attention_bwd(q, k, v, do, lse, delta, mode, fm, scale),
            (q, k, v, do), 3, sm_scale, (wide_kernel_head_dim(d, q.dtype),))

    def launch(q, k, v, do, scale):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        workspace = (
            torch.empty(q.shape, dtype=torch.float32, device=q.device)
            if q.dtype == torch.bfloat16 else None
        )
        _launch(
            "flash_attention_bwd", q, k, (q, k, v, do, lse, delta), (dq, dk, dv, workspace),
            mode, fm, scale,
        )
        return dq, dk, dv

    grads = on_kernel_head_dim(launch, (q, k, v, do), 3, sm_scale)
    flash_attention_bwd.launches += 1
    return grads


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP: the forward saves (q, k, v, o, lse); the
    backward recomputes p from lse in one backward call. Gradients come
    out in the inputs' dtype (bf16 under autocast)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, mask, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.causal, ctx.sm_scale = mask, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, do, lse, delta, ctx.mask, ctx.causal, ctx.sm_scale
        )
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: MaskLike = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention over [B, H, N, D] with an optional
    static mask (host numpy bool [n_q, n_k], True = attend, or a prepared
    `FlashMask`), the JAX package's `flash_attention` signature. With no
    mask, `causal` selects the causal arm; a mask replaces it."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v)
    if mask is not None and not isinstance(mask, FlashMask):
        mask = flash_mask(mask, q.device)  # analysed once for both passes
    return _FlashAttention.apply(q, k, v, mask, causal, sm_scale)

