"""Attention at head dims above 256 on the card: the wrappers of
`csrc/wide_head.cu`, reached through the decode wrappers of
`ops/flash_decode.py` and the flash-attention wrappers of
`ops/flash_attention.py` when D > WIDE_ABOVE (their tuned kernels stop at
256). Each function here launches its kernel on the current stream and
counts the calls in `.launches`; its plain version is the calling
wrapper's, which takes any D. Nothing here runs on the CPU: the calling
wrappers run their plain versions for CPU tensors before reaching this
module.

Flash attention in bfloat16 runs on tensor cores, one column group of
output columns a block (`wide_attention_plan`, which also sets each
launch's shared memory and residency): the forward
`wide_fwd_mma_kernel<cols, resident>` (cols 192 or 256), the backward one
fused `wide_bwd_mma_kernel<cols, resident>` (cols 128) between zeroing a
float32 dq workspace and converting it. The
caller zero-pads a D that is not a multiple of 8 to one
(`wide_kernel_head_dim`; the true D's scale, outputs cut back). float32 keeps
the CUDA-core kernels (`wide_fwd_kernel`; `wide_dq_kernel` and
`wide_dkv_kernel`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from dalle_pytorch_tpu_torch import kernels

WIDE_ABOVE = 256  # head dims above this run the kernels of this module
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 flash-attention kernels: output columns a block may own (their
# instances), the most a plan gives a block (the forward's accumulator is
# cols / 2 registers a thread, the backward's dK and dV cols), and what
# their shared memory holds: csrc/wide_head.cu's ring stages (kFwdStages,
# kFwdResStages, kBwdStages) and staged tiles; the plan passes each launch
# its bytes and residency
MMA_COLS = {"fwd": (192, 256), "bwd": (128,)}
MMA_MAX_COLS = {"fwd": 256, "bwd": 128}
MMA_ALIGN = 8  # D a multiple of this (16-byte rows)
FWD_STAGES, FWD_RES_STAGES, BWD_STAGES = 3, 4, 3
SMEM_SM, SMEM_RESERVED, SMEM_LIMIT = 233472, 1024, 232448  # an SM's, per block, a block's (227 KB)
_TILE = 64 * 72  # bf16 elements of a staged 64 x 64 tile (rows padded to 72)


def _resident_ld(d: int) -> int:
    return -(-d // 64) * 64 + 8


def mma_smem(kind: str, cols: int, d: int, resident: bool) -> int:
    """Dynamic shared bytes a block of the bf16 kernel `kind` takes: the
    forward a resident 64 x D query tile and a ring of one-tile slots, or a
    ring of two-tile slots; the backward resident 64 x D key and value tiles
    and a ring of two-tile slots, or a ring of four-tile slots and the keys
    at its columns, then dS^T, lse and delta."""
    if kind == "fwd":
        return 2 * (64 * _resident_ld(d) + FWD_RES_STAGES * _TILE if resident else FWD_STAGES * 2 * _TILE)
    ring = (2 * 64 * _resident_ld(d) + BWD_STAGES * 2 * _TILE if resident
            else BWD_STAGES * 4 * _TILE + 64 * (cols + 8))
    return 2 * (ring + _TILE) + 2 * 64 * 4


def mma_resident(kind: str, cols: int, d: int) -> bool:
    """Whether the kernel keeps its most re-read operand resident: the
    forward its query tile while two blocks still fit an SM, the backward
    its key and value tiles while its block fits."""
    if kind == "fwd":
        return 2 * (mma_smem(kind, cols, d, True) + SMEM_RESERVED) <= SMEM_SM
    return mma_smem(kind, cols, d, True) <= SMEM_LIMIT


@dataclass(frozen=True)
class WidePlan:
    """A launch of a bf16 wide kernel at head dim `d` (padded to `d_kernel`,
    a multiple of MMA_ALIGN): `groups` blocks per 64-row tile, group g owning
    output columns [g cols, min((g + 1) cols, d_kernel)), each computing the
    scores over all of D from `chunks` 64-channel chunks, with its most
    re-read operand `resident` in shared memory or streamed."""

    kind: str
    d_kernel: int
    cols: int
    groups: int
    chunks: int
    resident: bool
    smem: int

    @property
    def kernel(self) -> str:
        return f"wide_{self.kind}_mma_kernel<{self.cols}, {str(self.resident).lower()}>"

    def columns(self, group: int) -> range:
        return range(group * self.cols, min((group + 1) * self.cols, self.d_kernel))


def wide_kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim the kernels take for a true D above WIDE_ABOVE: the
    next multiple of MMA_ALIGN in bf16, D itself in fp32 (the caller
    zero-pads to it, `flash_attention.on_kernel_head_dim`)."""
    return -(-d // MMA_ALIGN) * MMA_ALIGN if dtype == torch.bfloat16 else d


def wide_attention_plan(d: int, kind: str) -> WidePlan:
    """The plan of the bf16 wide kernel `kind` ("fwd" or "bwd") at head dim
    `d` > WIDE_ABOVE: as few column groups as MMA_MAX_COLS allows, the
    64-channel chunks spread evenly over them, so the scores are recomputed
    ceil(chunks / (MMA_MAX_COLS / 64)) times."""
    if d <= WIDE_ABOVE:
        raise ValueError(f"head dim {d} is not above {WIDE_ABOVE}")
    d_kernel = wide_kernel_head_dim(d, torch.bfloat16)
    chunks = -(-d_kernel // 64)
    groups = -(-chunks // (MMA_MAX_COLS[kind] // 64))
    cols = 64 * -(-chunks // groups)
    if cols not in MMA_COLS[kind]:
        raise ValueError(f"no {kind} instance owns {cols} columns")
    resident = mma_resident(kind, cols, d_kernel)
    return WidePlan(kind, d_kernel, cols, groups, chunks, resident,
                    mma_smem(kind, cols, d_kernel, resident))


def wide_attention_kernels(d: int, dtype: torch.dtype) -> dict:
    """{"fwd": kernel, "bwd": (kernels...)} that flash attention launches on
    the card at head dim `d` > WIDE_ABOVE and `dtype` (the names a profiler
    trace shows; the backward's workspace memset and dq conversion aside)."""
    if dtype == torch.bfloat16:
        return {"fwd": wide_attention_plan(d, "fwd").kernel, "bwd": (wide_attention_plan(d, "bwd").kernel,)}
    if dtype == torch.float32:
        return {"fwd": "wide_fwd_kernel<float>",
                "bwd": ("wide_dq_kernel<float>", "wide_dkv_kernel<float>")}
    raise TypeError(f"no wide flash-attention kernel for {dtype}")


def _library() -> ctypes.CDLL:
    lib = kernels.library("wide_head")
    if lib.wide_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wide_decode_launch.argtypes = [p] * 9 + [i] * 11 + [ctypes.c_float, p]
        lib.wide_attention_fwd.argtypes = [p] * 7 + [i] * 10 + [ctypes.c_float, p]
        lib.wide_attention_bwd.argtypes = [p] * 12 + [i] * 10 + [ctypes.c_float, p]
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


def _launch_plan(d: int, dtype: torch.dtype, kind: str):
    """(cols, resident, smem) a launch passes: the bf16 plan's, zeros in fp32."""
    if dtype != torch.bfloat16:
        return 0, 0, 0
    plan = wide_attention_plan(d, kind)
    return plan.cols, int(plan.resident), plan.smem


def wide_attention_fwd(q, k, v, mode: int, fm, scale: float):
    """(o, lse) of the flash-attention forward at any D (bf16: a multiple of
    MMA_ALIGN); `mode` and the prepared mask `fm` as `ops/flash_attention.py`
    resolves them; bf16 by `wide_attention_plan(D, "fwd")`."""
    b, h, n_q, d = q.shape
    plan = _launch_plan(d, q.dtype, "fwd")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().wide_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), *_masks(fm), _ptr(o), _ptr(lse),
            b, h, n_q, k.shape[2], d, _DTYPE_CODE[q.dtype], mode, *plan, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "wide_attention_fwd")
    wide_attention_fwd.launches += 1
    wide_attention_fwd.mma_launches += int(plan[0] > 0)
    return o, lse


def wide_attention_bwd(q, k, v, do, lse, delta, mode: int, fm, scale: float):
    """(dq, dk, dv) of the flash-attention backward at any D (bf16: a
    multiple of MMA_ALIGN): bf16 one fused kernel by `wide_attention_plan(D,
    "bwd")` (dq through a float32 workspace allocated here), float32 two
    kernels (dq, then dk/dv)."""
    b, h, n_q, d = q.shape
    plan = _launch_plan(d, q.dtype, "bwd")
    workspace = None
    if q.dtype == torch.bfloat16:
        workspace = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _library().wide_attention_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), *_masks(fm),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(workspace), b, h, n_q, k.shape[2], d,
            _DTYPE_CODE[q.dtype], mode, *plan, scale, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "wide_attention_bwd")
    wide_attention_bwd.launches += 1
    wide_attention_bwd.mma_launches += int(plan[0] > 0)
    return dq, dk, dv


wide_decode.launches = 0
wide_attention_fwd.launches = 0
wide_attention_bwd.launches = 0
# the bf16 calls among .launches: the tensor-core kernels
wide_attention_fwd.mma_launches = 0
wide_attention_bwd.mma_launches = 0
