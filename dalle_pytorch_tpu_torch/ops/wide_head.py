"""Attention at head dims above 256 on the card: the wrappers of
`csrc/wide_head.cu`, reached through the decode wrappers of
`ops/flash_decode.py` and the flash-attention wrappers of
`ops/flash_attention.py` when D > WIDE_ABOVE (their tuned kernels stop at
256). Each function here launches its kernel on the current stream and
counts the calls in `.launches`; its plain version is the calling
wrapper's, which takes any D. Nothing here runs on the CPU: the calling
wrappers run their plain versions for CPU tensors before reaching this
module.

Decode (`wide_decode`, its kernel named by `wide_arm`) runs the split-K
kernel `wide_split_kernel` up to WIDE_SPLIT_ROWS query rows (the step, at
any D: spans of 128 keys merged by the last block to arrive, as
flash_decode.cu's split-K body, through `split_scratch`; `wide_split_plan`
gives its chunks of columns a thread, column groups, keys a tile and
shared bytes); above WIDE_SPLIT_ROWS rows with bf16 q the tensor-core tile
kernel of `csrc/wide_decode_tile.cu` (`wide_decode_tile_kernel<KV, cols,
resident>`: 64 query rows x a column group a block, S over all of D from
64-channel chunks through a cp.async ring, P as a bf16 pair;
`wide_tile_plan`), with fp32 q the CUDA-core `wide_decode_fma_kernel<KV,
cols>` (64 query rows x a group of up to 320 columns a block, S formed
once a group as register micro-tiles, the fp32 tile arm's arithmetic over
64-key tiles; `wide_fp32_plan(d, "decode", quant)`).

Flash attention in bfloat16 runs on tensor cores, one column group of
output columns a block (`wide_attention_plan`, which also sets each
launch's shared memory and residency): the forward
`wide_fwd_mma_kernel<cols, resident>` (cols 192 or 256), the backward one
fused `wide_bwd_mma_kernel<cols, resident>` (cols 128) between zeroing a
float32 dq workspace and converting it. The
caller zero-pads a D that is not a multiple of 8 to one
(`wide_kernel_head_dim`; the true D's scale, outputs cut back). float32
runs on CUDA cores at any D, unpadded, in register-tiled kernels that form
S (and dP) once per group of up to 320 output columns (`wide_fp32_plan`):
the forward `wide_fwd_fma_kernel<cols>` (64 query rows a block), the
backward two passes, `wide_dq_fma_kernel<cols>` (64 query rows a block)
then `wide_dkv_fma_kernel<cols>` (32 keys a block).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from dalle_pytorch_tpu_torch import kernels

WIDE_ABOVE = 256  # head dims above this run the kernels of this module
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# decode: the split-K kernel takes up to this many query rows (csrc
# kSplitRows, ops/flash_decode.py DECODE_ROWS) at any head dim; its launch
# plan (csrc/wide_head.cu `split_chunks`, `split_groups`, `split_piece`,
# `split_tile_keys`, `split_smem_bytes`): 128 threads, each owning SPLIT_CHUNKS
# chunks of 4 output columns (the first up to SPLIT_NARROW_D channels),
# groups of the widest instance's columns above it, key tiles within
# SPLIT_STAGE_BYTES of K + V rows, a ring of SPLIT_STAGES stages, and its
# static shared memory (two score arrays, the softmax state, the page-table
# cache, a flag)
WIDE_SPLIT_ROWS = 4
SPLIT_THREADS, SPLIT_STAGES, SPLIT_STAGE_BYTES, SPLIT_KEYS = 128, 3, 32768, 16
SPLIT_CHUNKS, SPLIT_NARROW_D = (2, 8), 1024
SPLIT_STATIC_SMEM = 4 * (2 * WIDE_SPLIT_ROWS * SPLIT_KEYS + 3 * WIDE_SPLIT_ROWS + 129 + 1)

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
# the decode tile kernel (csrc/wide_decode_tile.cu): the output columns a
# block owns (kCols: a warp's O is 16 x 192 fp32 beside P's bf16 pair; 256
# columns spilled) and its ring stages (kStages, kResStages)
TILE_COLS = 192
TILE_STAGES, TILE_RES_STAGES = 3, 4
TILE_STATIC_SMEM = 128 * 4 + 2 * 64 * 8  # its static shared memory (kStaticSmem)
# the fp32 kernels (csrc `wide_fwd_fma_kernel`, `wide_decode_fma_kernel`, the
# backward's `wide_dq_fma_kernel` and `wide_dkv_fma_kernel`): their column
# instances (O and dQ are 4 rows x cols / 16 registers a thread, dK and dV 2
# keys x cols / 16 each), the rows a block owns, and their shared memory: a
# ring of 2 slots of eight 64 x 32 fp32 sub-tiles (rows padded to 36), then
# 64 rows of P (padded to 72), and of dS in the backward (kFmaSmem,
# kFwdFmaSmem); an int8 decode slot adds 64 raw rows of up to 256 int8
# channels (288 bytes apart) and their scales (csrc decode_fma_smem)
FMA_COLS = (192, 256, 320)
FMA_ROWS = {"fwd": 64, "decode": 64, "dq": 64, "dkv": 32}
FMA_SMEM = 4 * (2 * 8 * 64 * 36 + 2 * 64 * 72)
FWD_FMA_SMEM = 4 * (2 * 8 * 64 * 36 + 64 * 72)
RAW_SLOT = 64 * 288 + 64 * 4
DECODE_STATIC_SMEM = 128 * 4  # the decode's staged page-table entries (kDecTableCache)


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
        if self.kind == "tile":  # the cache type is the first template argument
            return f"wide_decode_tile_kernel<KV, {self.cols}, {str(self.resident).lower()}>"
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


class Fp32Plan(NamedTuple):
    """A launch of the fp32 kernel `kind` ("fwd", "decode", or the
    backward's passes "dq" and "dkv") at head dim `d`: blocks of `rows`
    query rows (keys for dkv), `groups` of them per row tile, group g
    owning output columns [g cols, min((g + 1) cols, d)), each forming S
    (and dP) over all of D; `smem` dynamic shared bytes a block."""

    kind: str
    d: int
    rows: int
    cols: int
    groups: int
    smem: int

    @property
    def kernel(self) -> str:
        if self.kind == "decode":  # the cache type is the first template argument
            return f"wide_decode_fma_kernel<KV, {self.cols}>"
        return f"wide_{self.kind}_fma_kernel<{self.cols}>"

    def columns(self, group: int) -> range:
        return range(group * self.cols, min((group + 1) * self.cols, self.d))


def fma_smem(kind: str, quant: bool = False) -> int:
    """Dynamic shared bytes a block of the fp32 kernel `kind` takes (an
    int8 cache: `quant`)."""
    if kind in ("dq", "dkv"):
        return FMA_SMEM
    return FWD_FMA_SMEM + (2 * RAW_SLOT if kind == "decode" and quant else 0)


def wide_fp32_plan(d: int, kind: str, quant: bool = False) -> Fp32Plan:
    """The plan of the fp32 kernel `kind` (FMA_ROWS' keys) at head dim `d` >
    WIDE_ABOVE: as few column groups as the widest instance (max(FMA_COLS)
    columns) allows, D's 64-column chunks spread evenly over them, so S is
    formed once up to D = 320 and twice up to 640. The backward's passes
    take the same columns, so one `cols` goes to their launch."""
    if d <= WIDE_ABOVE:
        raise ValueError(f"head dim {d} is not above {WIDE_ABOVE}")
    chunks = -(-d // 64)
    cols = 64 * -(-chunks // -(-chunks // (max(FMA_COLS) // 64)))
    if cols not in FMA_COLS:
        raise ValueError(f"no fp32 {kind} instance owns {cols} columns")
    return Fp32Plan(kind, d, FMA_ROWS[kind], cols, -(-d // cols), fma_smem(kind, quant))


class SplitPlan(NamedTuple):
    """A launch of the split-K step at head dim `d` with a cache of `elt`
    bytes an element and `rows` (1 or WIDE_SPLIT_ROWS) query rows a block:
    `chunks` chunks of 4 output columns a thread, `groups` column groups
    (each a block per span; the scores formed in each), `piece` channels of
    a staged K or V row (all of D in one group), `tile_keys` keys a stage,
    `smem` dynamic shared bytes a block."""

    d: int
    chunks: int
    groups: int
    piece: int
    tile_keys: int
    smem: int

    def columns(self, group: int) -> range:
        cols = self.chunks * 4 * SPLIT_THREADS
        return range(group * cols, min((group + 1) * cols, self.d))


def _split_row_stride(w: int, elt: int) -> int:
    return ((w + 7) // 8 * 8 * elt + 15) // 16 * 16


def wide_split_plan(d: int, elt: int, rows: int = WIDE_SPLIT_ROWS) -> SplitPlan:
    """The split-K step's plan at head dim `d` (csrc/wide_head.cu computes
    the same and refuses a launch whose chunks or shared bytes differ): the
    narrow instance up to SPLIT_NARROW_D channels, the wide one above; one
    column group up to the wide instance's columns (every K byte read
    once), ceil(D / its columns) above; the largest power of two of keys up
    to SPLIT_KEYS whose K and V rows fit SPLIT_STAGE_BYTES."""
    chunks = SPLIT_CHUNKS[0] if d <= SPLIT_NARROW_D else SPLIT_CHUNKS[1]
    group_cols = chunks * 4 * SPLIT_THREADS
    groups = -(-d // group_cols)
    piece = d if groups == 1 else group_cols
    keys = SPLIT_KEYS
    while keys > 1 and 2 * keys * _split_row_stride(piece, elt) > SPLIT_STAGE_BYTES:
        keys //= 2
    stage = 2 * keys * _split_row_stride(piece, elt) + (2 * keys * 4 if elt == 1 else 0)
    smem = SPLIT_STAGES * stage + rows * (-(-piece // 8) * 8) * 4
    return SplitPlan(d, chunks, groups, piece, keys, smem)


def wide_tile_smem(d: int, resident: bool, quant: bool) -> int:
    """Dynamic shared bytes a block of the decode tile kernel takes at head
    dim `d`: the resident 64 x D query tile and a ring of 4 one-tile slots,
    or a ring of 3 two-tile slots; int8 adds the slot's tiles widened to
    bf16 and two key tiles' k and v scales (csrc `smem_bytes`)."""
    tiles, stages = (1, TILE_RES_STAGES) if resident else (2, TILE_STAGES)
    nbytes = 2 * (64 * _resident_ld(d) if resident else 0) + 2 * stages * tiles * _TILE
    return nbytes + (2 * tiles * _TILE + 2 * 2 * 64 * 4 if quant else 0)


def wide_tile_plan(d: int, quant: bool = False) -> WidePlan:
    """The launch plan of the decode tile kernel at head dim `d` (any D,
    the channels past D zero in shared memory; `quant`: an int8 cache):
    groups of TILE_COLS output columns, each forming S over all of D's
    64-channel chunks; Q resident while two blocks still fit an SM."""
    resident = 2 * (wide_tile_smem(d, True, quant) + TILE_STATIC_SMEM + SMEM_RESERVED) <= SMEM_SM
    return WidePlan("tile", d, TILE_COLS, -(-d // TILE_COLS), -(-d // 64), resident,
                    wide_tile_smem(d, resident, quant))


def wide_attention_kernels(d: int, dtype: torch.dtype) -> dict:
    """{"fwd": kernel, "bwd": (kernels...)} that flash attention launches on
    the card at head dim `d` > WIDE_ABOVE and `dtype` (the names a profiler
    trace shows; the backward's workspace memset and dq conversion aside)."""
    if dtype == torch.bfloat16:
        return {"fwd": wide_attention_plan(d, "fwd").kernel, "bwd": (wide_attention_plan(d, "bwd").kernel,)}
    if dtype == torch.float32:
        return {"fwd": wide_fp32_plan(d, "fwd").kernel,
                "bwd": tuple(wide_fp32_plan(d, kind).kernel for kind in ("dq", "dkv"))}
    raise TypeError(f"no wide flash-attention kernel for {dtype}")


def _tile_library() -> ctypes.CDLL:
    lib = kernels.library("wide_decode_tile")
    fn = lib.wide_decode_tile_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    lib = kernels.library("wide_head")
    if lib.wide_split_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wide_split_launch.argtypes = [p] * 9 + [i] * 13 + [ctypes.c_float, p, p, p]
        lib.wide_decode_fma_launch.argtypes = [p] * 9 + [i] * 12 + [ctypes.c_float, p]
        lib.wide_attention_fwd.argtypes = [p] * 7 + [i] * 10 + [ctypes.c_float, p]
        lib.wide_attention_bwd.argtypes = [p] * 12 + [i] * 10 + [ctypes.c_float, p]
        for fn in (lib.wide_split_launch, lib.wide_decode_fma_launch,
                   lib.wide_attention_fwd, lib.wide_attention_bwd):
            fn.restype = ctypes.c_int
        lib.wide_split_workspace_floats.restype = ctypes.c_longlong
        lib.wide_split_workspace_floats.argtypes = [i] * 4
    return lib


_counters = {}  # device -> int32 arrival counters of the split-K kernels, zero between calls


def split_scratch(device: torch.device, floats: int, rows: int):
    """(workspace, counters) of a split-K decode call (flash_decode.cu's or
    this module's), or (None, None) when it needs no workspace (`floats`
    0): a float32 workspace of `floats` for the spans' partial states
    (fresh from the caching allocator) and int32 arrival counters for
    `rows` (batch row, head[, column group]) merges, zeroed once per device and left zero by
    every call, so a call needs no memset. Calls on one device share the
    counters: they run on one stream at a time."""
    if floats == 0:
        return None, None
    counters = _counters.get(device)
    if counters is None or counters.numel() < rows:
        counters = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
        _counters[device] = counters
    return torch.empty(floats, dtype=torch.float32, device=device), counters


def wide_split_takes(n: int) -> bool:
    """Whether a decode call of n query rows at a head dim above WIDE_ABOVE
    runs the split-K kernel (`wide_split_kernel`): up to WIDE_SPLIT_ROWS
    rows, at any D."""
    return n <= WIDE_SPLIT_ROWS


def wide_tile_takes(n: int, dtype: torch.dtype) -> bool:
    """Whether a decode call of n query rows in q's `dtype` at a head dim
    above WIDE_ABOVE runs the tensor-core tile kernel (csrc/
    wide_decode_tile.cu): bf16 q above WIDE_SPLIT_ROWS rows, at any D."""
    return dtype == torch.bfloat16 and n > WIDE_SPLIT_ROWS


def wide_arm(n: int, dtype: torch.dtype, d: int) -> str:
    """The kernel a decode call of n query rows in q's `dtype` at head dim
    `d` > WIDE_ABOVE launches: "wide_split" (`wide_split_takes`, any D),
    "wide_tile" (`wide_tile_takes`), else "wide_tile_f32" (fp32 q above
    WIDE_SPLIT_ROWS rows, any D: `wide_decode_fma_kernel`)."""
    if wide_split_takes(n):
        return "wide_split"
    return "wide_tile" if wide_tile_takes(n, dtype) else "wide_tile_f32"


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
    when paged); int8 K/V with their scales. On the kernel `wide_arm`
    names: the split-K kernel (counted also in `.split_launches`), the
    tensor-core tile kernel (`.tile_launches`) or the fp32 multi-row kernel
    (`.tile_f32_launches`)."""
    b, h, n, d = q.shape
    paged = page_table is not None
    s_len = page_table.shape[1] * k.shape[2] if paged else k.shape[2]
    quant = k_scale is not None
    arm = wide_arm(n, q.dtype, d)
    tensors = [q, k, v] + ([k_scale, v_scale] if quant else [])
    if arm == "wide_tile" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k, v and scales must be 16-byte aligned")
    out = torch.empty_like(q)
    args = (
        _ptr(q), _ptr(k), _ptr(v), _ptr(k_scale), _ptr(v_scale), _ptr(lengths),
        _ptr(block_bitmap), _ptr(page_table), _ptr(out), b, h, n, s_len, d,
        0 if block_bitmap is None else block_bitmap.shape[1], int(block_k),
        k.shape[2] if paged else 0, k.shape[0] if paged else 0,
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if arm == "wide_tile":
            plan = wide_tile_plan(d, quant)
            err = _tile_library().wide_decode_tile_launch(
                *args, int(quant), plan.cols, int(plan.resident), plan.smem, d**-0.5, stream)
        elif arm == "wide_tile_f32":
            plan = wide_fp32_plan(d, "decode", quant)
            err = _library().wide_decode_fma_launch(*args, int(quant), plan.cols, plan.smem, d**-0.5, stream)
        else:
            lib = _library()
            plan = wide_split_plan(d, k.element_size(), 1 if n == 1 else WIDE_SPLIT_ROWS)
            workspace, counters = split_scratch(
                q.device, lib.wide_split_workspace_floats(b, h, s_len, d), b * h * plan.groups)
            err = lib.wide_split_launch(*args, _DTYPE_CODE[q.dtype], int(quant), plan.chunks, plan.smem,
                                        d**-0.5, stream, _ptr(workspace), _ptr(counters))
    _raise_on(err, arm)
    wide_decode.launches += 1
    wide_decode.split_launches += arm == "wide_split"
    wide_decode.tile_launches += arm == "wide_tile"
    wide_decode.tile_f32_launches += arm == "wide_tile_f32"
    return out


def _masks(fm):
    return (None, None) if fm is None else (fm.mask.data_ptr(), fm.layout.data_ptr())


def _launch_plan(d: int, dtype: torch.dtype, kind: str):
    """(cols, resident, smem) a launch passes: the bf16 plan's; in fp32
    `wide_fp32_plan`'s (the backward's one for both passes)."""
    if dtype != torch.bfloat16:
        plan = wide_fp32_plan(d, "fwd" if kind == "fwd" else "dq")
        return plan.cols, 0, plan.smem
    plan = wide_attention_plan(d, kind)
    return plan.cols, int(plan.resident), plan.smem


def wide_attention_fwd(q, k, v, mode: int, fm, scale: float):
    """(o, lse) of the flash-attention forward at any D (bf16: a multiple of
    MMA_ALIGN); `mode` and the prepared mask `fm` as `ops/flash_attention.py`
    resolves them; bf16 by `wide_attention_plan(D, "fwd")`, fp32 on the
    register-tiled `wide_fwd_fma_kernel` by `wide_fp32_plan(D, "fwd")`."""
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
    wide_attention_fwd.mma_launches += int(q.dtype == torch.bfloat16)
    return o, lse


def wide_attention_bwd(q, k, v, do, lse, delta, mode: int, fm, scale: float):
    """(dq, dk, dv) of the flash-attention backward at any D (bf16: a
    multiple of MMA_ALIGN): bf16 one fused kernel by `wide_attention_plan(D,
    "bwd")` (dq through a float32 workspace allocated here), float32 two
    register-tiled CUDA-core passes by `wide_fp32_plan` (dq, then
    dk/dv; no workspace, every output bit-identical run to run)."""
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
    wide_attention_bwd.mma_launches += int(q.dtype == torch.bfloat16)
    return dq, dk, dv


wide_decode.launches = 0
wide_decode.split_launches = 0  # of those, the split-K kernel's
wide_decode.tile_launches = 0  # and the tensor-core tile kernel's
wide_decode.tile_f32_launches = 0  # and the fp32 multi-row kernel's
wide_attention_fwd.launches = 0
wide_attention_bwd.launches = 0
# the bf16 calls among .launches: the tensor-core kernels
wide_attention_fwd.mma_launches = 0
wide_attention_bwd.mma_launches = 0
