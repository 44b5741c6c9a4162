#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dalle_pytorch_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each failing loudly (nonzero exit, no result line):

1. the card's name and power limit (nvidia-smi), and the build of every
   kernel of the port's two main paths from `dalle_pytorch_tpu_torch/csrc/`
   (one nvcc per source, started together);
2. each kernel against its plain PyTorch version at the main paths'
   shapes, in bfloat16 and float32, with the tolerance stated (and at
   small shapes for the other head dims: the decode kernels at D = 8 to
   256 (`DECODE_OTHER_DIMS`), a 5-row chunk and a split-K step each;
   flash attention at D = 16, 32, 48, 128, 192 and 256, the D that are no
   instance through the wrappers' zero padding; for flash
   attention also a ragged length, an axial_row static mask and the arm
   with neither causality nor a mask, each
   output held per element and per 64-row tile, and in bfloat16 also
   against the plain version that rounds P and dS as the kernels do);
   D = 264 must raise in the decode and attention wrappers;
3. times with CUDA events: each kernel, its plain version and one PyTorch
   library call computing the same function, beside the kernel's bound
   (the larger of bytes over memory bandwidth and flops over peak rate
   for the input type, this card's published peaks), flash attention
   also at D = 256; after phase 8 (a torch.profiler trace slows the
   launches after it) each bf16 kernel row's device time per call from a
   trace of the same timed calls (`device_ms`: CUDA events around
   back-to-back calls read the wrapper's host time once the kernel is
   shorter), and the CUDA kernel the bf16 forward's row ran
   (`cuda_kernel`: the wgmma kernel at D = 64);
4. a small float32 model on the card, through the kernels against the
   same model through dense attention: its cached decode, and its training
   loss and every gradient;
5. the generation path once: the micro `GenerationEngine` at the flagship
   width (DALLE dim 1024, depth 12, 16 heads of 64, 256 text + 1024 image
   tokens, 256 px dVAE; random weights from a seed; bfloat16; batch 4),
   `warmup()` then `generate()` of four prompts, with the flash_decode
   launch count read from zero around the `generate()` call;
6. the training path: the same DALLE with float32 parameters under
   bfloat16 autocast, `attn_impl="auto"`, forward_only, batch 4 of seeded
   tokens; one warmup step, then 5 Adam steps on the same batch with the
   flash-attention launch counts read from zero around them; the loss must
   fall; then `save_dalle_checkpoint`, `engine_from_checkpoint` and one
   `generate()` from it (train -> checkpoint -> serve);
7. the continuous-serving path: phase 5's model behind a `ContinuousEngine`
   (4 slots, prefill waves of 4, chunks of 4 tokens) driven by the
   `ContinuousBatcher` with phase 5's four prompts, two of them admitted
   mid-flight: causal (tokens identical to phase 5's, one chunk run under
   CUDA's sync-debug "error" mode); on the model's first 4 layers (a
   depth cut that holds the script's time) causal, int8 KV and policy
   sparsity (tokens identical to that causal run); and policy + int8 on
   a model whose layers cycle full / axial_row / axial_col / conv_like;
   each run's kernel launches counted exactly;
8. the paged-serving path: phase 5's model behind a `PagedContinuousEngine`
   (4 slots, page 32, prefill waves of 4, chunks of 4) and the
   `ContinuousBatcher`, with phase 7's four requests and repeats of the
   first two (full-prompt prefix hits, no prefill dispatch), three times:
   the gather impl (tokens identical to phase 7's causal run), the paged
   kernel with a pool of two rows' worst case beside the prefix cache
   (the batcher holds requests back; tokens identical again; one chunk
   under sync-debug "error"), and the block-sparse paged kernel's int8 arm
   under policy + int8 on phase 7's patterned model (tokens identical to
   phase 7's run of it); launches counted exactly, `leak_check()` empty.

Phases 2 and 3 also hold and time the int8 arm of flash decode, the
block-sparse kernel (all-ones bitmaps bit-identical to flash decode,
random and policy bitmaps, poisoned dead tiles) and the two paged kernels
(page sizes 16-128, shuffled tables sharing pages, NaN-poisoned pools;
bit for bit the all-ones page bitmap against the paged kernel, and each
paged kernel against its contiguous twin on the gathered view, at D = 16
to 256 and at split-K steps).

The line before the last is the card's nvidia-smi line, the one before
that a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout, it exits nonzero before any result.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
LAYERS = 12  # flagship depth: the timed inputs rotate over this many copies
MAIN = dict(batch=4, heads=16, dim_head=64, cache=1281, prefill=257)
TRAIN = dict(batch=4, heads=16, n=1280, dim_head=64)  # flash attention's shapes
# decode head dims besides the main paths' D = 64 (any D <= 256 runs on the
# card: 36 and 38 take the 4-byte and plain copies of int8 rows)
DECODE_OTHER_DIMS = (8, 16, 32, 36, 38, 40, 48, 72, 80, 96, 112, 128, 200, 256)
ATTENTION_OTHER_DIMS = (16, 32, 48, 128, 192, 256)  # flash attention's, small shapes
FLAGSHIP = dict(
    dim=1024, depth=LAYERS, heads=16, dim_head=64, num_image_tokens=8192,
    image_fmap_size=32, num_text_tokens=10000, text_seq_len=256,
    shift_tokens=True, rotary_emb=True, attn_types=("full",),
)
REPO = Path(__file__).resolve().parent
# published peaks (NVIDIA data sheets, dense): HBM bytes/s, bf16 and fp32
# (non-tensor-core) flop/s
PEAKS = {
    "H100 SXM": dict(bytes=3.35e12, bf16=989e12, fp32=67e12),
    "H100 PCIe": dict(bytes=2.0e12, bf16=756e12, fp32=51e12),
    "H100 NVL": dict(bytes=3.9e12, bf16=835e12, fp32=60e12),
}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_peaks(name: str):
    if "H100" in name and "PCIe" in name:
        return "H100 PCIe", PEAKS["H100 PCIe"]
    if "H100" in name and "NVL" in name:
        return "H100 NVL", PEAKS["H100 NVL"]
    if "H100" not in name:
        print(f"note: {name!r} is not an H100; bounds use the H100 SXM peaks")
    return "H100 SXM", PEAKS["H100 SXM"]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def flash_inputs(torch, n, lengths, dtype, copies=1):
    """`copies` independent (q, k, v, lengths) sets at the main path's
    [B, H, S, D]; random values everywhere, dead cache positions included."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, h, d, s = MAIN["batch"], MAIN["heads"], MAIN["dim_head"], MAIN["cache"]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return [
        tuple(
            torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, h, n, d), (b, h, s, d), (b, h, s, d))
        ) + (lens,)
        for _ in range(copies)
    ]


def flash_bound(n, lengths, elt, peaks, dtype_key):
    """(bound_ms, bound_by): each input read once (live K/V only), the
    output written once; 4*D flops per visible (query row, key) pair."""
    b, h, d, s = MAIN["batch"], MAIN["heads"], MAIN["dim_head"], MAIN["cache"]
    live = [min(max(x, 0), s) for x in lengths]
    nbytes = (2 * b * h * n * d + 2 * h * d * sum(live)) * elt + 4 * b
    pairs = sum(max(0, min(x - n + i + 1, s)) for x in live for i in range(n))
    flops = 4 * d * h * pairs
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / peaks[dtype_key]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# Flash attention against its plain version, held locally: per element
# |err| / (|ref| + the rms of ref over its 64-row tile), and per 64-row
# tile of each (batch row, head) ||err|| / ||ref||. Limits (element or
# None, tile), with the worst ratios an H100 gave at these seeds:
ATTN_TOL = {
    # bf16 kernel vs the exact function: the output's rounding (2^-8 |ref|)
    # plus P's or dS's (2^-9 relative per term) summed over up to 1280
    # terms; worst seen 2.6e-2 per element, 3.8e-3 per tile
    "bf16_exact": (2.0**-4, 1e-2),
    # bf16 kernel vs the plain version that rounds P and dS to bf16 where
    # the kernel does: both round nearly equal float32 values, so the two
    # differ only where a float32 difference flips a rounding (one bf16
    # ulp of that term). Per tile only: a flip of a row's dominant term is
    # a large share of that one element. o and dv (products of P): worst
    # seen 6.1e-4
    "bf16_matched_p": (None, 1e-3),
    # dq and dk (products of dS = P (dP - delta)): where a row's P is
    # concentrated, dP - delta cancels, so the float32 difference between
    # the kernel's and the plain dP sums flips dS's rounding often on the
    # dominant terms; worst seen 2.7e-3 (axial_row)
    "bf16_matched_ds": (None, 6e-3),
    # float32 throughout (lse always): summation order only; worst seen
    # 5.6e-6 per element, 5.8e-7 per tile
    "fp32": (2e-5, 1e-5),
}


def attention_closeness(torch, out, ref):
    """(max |err|, worst element ratio, worst tile ratio) of out against
    ref, both [B, H, N, D] or [B, H, N] (lse); tiles are 64 rows of N."""
    import torch.nn.functional as F

    out, ref = out.float(), ref.float()
    if ref.dim() == 3:
        out, ref = out[..., None], ref[..., None]
    b, h, n, d = ref.shape
    pad = (-n) % 64
    err = F.pad(out - ref, (0, 0, 0, pad)).view(b, h, -1, 64, d)
    r = F.pad(ref, (0, 0, 0, pad)).view(b, h, -1, 64, d)
    rows = (n - 64 * torch.arange(err.shape[2], device=ref.device)).clamp(max=64)
    ref_sq = r.square().sum((-1, -2))
    rms = (ref_sq / (rows * d)).sqrt()[..., None, None]
    element = (err.abs() / (r.abs() + rms).clamp(min=1e-30)).amax().item()
    tile = (err.square().sum((-1, -2)).sqrt() / ref_sq.sqrt().clamp(min=1e-30)).amax().item()
    if not torch.isfinite(out).all():
        element = tile = math.inf
    return err.abs().max().item(), element, tile


def attention_bound(kind, elt, peaks, dtype_key, d=TRAIN["dim_head"]):
    """(bound_ms, bound_by) of one flash-attention pass at TRAIN's causal
    shapes (head dim `d`): each input read once and each output written
    once; 4*D (fwd: S, P.V) or 10*D (bwd: S, dP, dV, dK, dQ) flops per
    visible (query, key) pair."""
    b, h, n = TRAIN["batch"], TRAIN["heads"], TRAIN["n"]
    rows, pairs = b * h * n, b * h * n * (n + 1) // 2
    nbytes, flops = {
        "fwd": (4 * rows * d * elt + 4 * rows, 4 * d * pairs),    # q,k,v,o + lse
        "bwd": (7 * rows * d * elt + 8 * rows, 10 * d * pairs),   # q,k,v,do,dq,dk,dv + lse,delta
    }[kind]
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / peaks[dtype_key]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def launched_kernel(torch, fn, args):
    """The device kernel that one call fn(*args) launches, as a
    torch.profiler trace of that call names it ("fwd_wgmma_kernel<64>");
    fails unless the trace holds exactly one kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = [
        evt.name for evt in prof.events()
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation
    ]
    if len(names) != 1:
        fail(f"{fn.__name__}: expected one device kernel in its trace, saw {names}")
    found = re.search(r"\w+_kernel<[^<>]*>", names[0])
    return found.group(0) if found else names[0]


def time_ms(torch, fn, inputs, iters):
    """Mean ms per call over `iters` calls rotating through `inputs` (one
    set per layer: each call finds its K/V cold in L2, as in decode).
    CUDA events around back-to-back calls: where the kernel is shorter
    than the wrapper's host time this reads the host (see device_ms)."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for it in range(iters):
        fn(*inputs[it % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, inputs, iters):
    """(ms, {kernel name: launches}) per call on the card: the device time
    of every kernel and memset the `iters` calls launch (rotating through
    `inputs`, as time_ms), summed from a torch.profiler trace of them and
    divided by `iters`. Traces slow the launches after them, so these run
    after every other timed phase."""
    from torch.profiler import ProfilerActivity, profile

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for it in range(iters):
            fn(*inputs[it % len(inputs)])
        torch.cuda.synchronize()
    total_us, names = 0.0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            total_us += evt.time_range.elapsed_us()
            found = re.search(r"\w+_kernel<[^<>]*>|\w+_kernel\b", evt.name)
            name = found.group(0) if found else evt.name[:60]
            names[name] = names.get(name, 0) + 1
    if not names:
        fail(f"{getattr(fn, '__name__', fn)}: the trace holds no device activity")
    return total_us / iters / 1e3, {k: n / iters for k, n in names.items()}


# rows of phase 3 whose device time is taken after phase 8: (row, fn,
# inputs, iters); device_ms fills row["device_ms"] and row["device_kernels"]
DEVICE_ROWS = []


def defer_device_time(row, fn, inputs, iters):
    DEVICE_ROWS.append((row, fn, inputs, iters))


# the flagship geometry's pattern layers, for the policy bitmaps of phase 2
# and 3 (a stand-in with the attributes DecodeSparsityPolicy reads)
PATTERNED = ("full", "axial_row", "axial_col", "conv_like")


def policy_bitmaps(attn_types, positions, chunk=1):
    """[len(attn_types), B, nb] bitmaps of the decode-sparsity policy at the
    flagship geometry for slots at image `positions`."""
    from types import SimpleNamespace

    import numpy as np

    from dalle_pytorch_tpu_torch.serving.sparsity import DecodeSparsityPolicy

    geo = SimpleNamespace(
        text_seq_len=FLAGSHIP["text_seq_len"], image_seq_len=FLAGSHIP["image_fmap_size"] ** 2,
        total_seq_len=FLAGSHIP["text_seq_len"] + FLAGSHIP["image_fmap_size"] ** 2,
        image_fmap_size=FLAGSHIP["image_fmap_size"], depth=len(attn_types),
        attn_types=attn_types, decode_sparse_block=128,
    )
    policy = DecodeSparsityPolicy(geo, chunk, len(positions))
    return policy.chunk_bitmaps(np.asarray(positions), np.ones(len(positions), bool))


def quantized(torch, k, v):
    from dalle_pytorch_tpu_torch.models.attention import _kv_quantize

    (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
    return kq, vq, ks, vs


def decode_tol(torch, ref, dtype):
    """Kernel 1's limits: bf16 one rounding step of the largest output,
    fp32 summation order only."""
    scale = max(1.0, ref.float().abs().max().item())
    return 2.0**-7 * scale if dtype == torch.bfloat16 else 2e-5 * scale


def check_decode_variants(torch, cases):
    """Phase 2 for the int8 arm and the block-sparse kernel; returns
    {kernel: worst bf16 max_abs_err against the plain version}."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    worst = {"flash_decode_int8": 0.0, "block_sparse_flash_decode": 0.0}
    failures = []

    def arms(k, v):
        """(label, k, v, scales) of the cache in q's dtype and of int8."""
        kq, vq, ks, vs = quantized(torch, k, v)
        return (("", k, v, ()), (" int8", kq, vq, (ks, vs)))

    def hold(kernel, label, out, ref, dtype):
        err = (out.float() - ref.float()).abs().max().item()
        tol = decode_tol(torch, ref, dtype)
        print(f"check {kernel} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} tol {tol:.3e}")
        if not (err <= tol and torch.isfinite(out).all()):
            failures.append(f"{kernel} {label} {dtype}: {err:.3e} over {tol:.3e}")
        if dtype == torch.bfloat16:
            worst[kernel] = max(worst[kernel], err)

    def hold_all(label, q, kv_arms, lens, bm, block, dtype):
        """The int8 arm against its plain version, each arm of the
        block-sparse kernel against its plain version on `bm`, and each
        arm on an all-ones bitmap against flash_decode bit for bit."""
        _, kq, vq, scales = kv_arms[1]
        hold("flash_decode_int8", label, fd.flash_decode_attention(q, kq, vq, lens, *scales),
             fd.flash_decode_attention_plain(q, kq, vq, lens, *scales), dtype)
        ones = torch.ones_like(bm)
        for suffix, kk, vv, sc in kv_arms:
            hold("block_sparse_flash_decode", f"{label}{suffix}",
                 fd.block_sparse_flash_decode_attention(q, kk, vv, lens, bm, block, *sc),
                 fd.block_sparse_flash_decode_attention_plain(q, kk, vv, lens, bm, block, *sc),
                 dtype)
            a = fd.block_sparse_flash_decode_attention(q, kk, vv, lens, ones, block, *sc)
            b = fd.flash_decode_attention(q, kk, vv, lens, *sc)
            same = torch.equal(a, b)
            print(f"check block_sparse_flash_decode {label}{suffix} {str(dtype)[6:]}: all-ones "
                  f"bitmap vs flash_decode max_abs_err "
                  f"{(a.float() - b.float()).abs().max().item():.1e}, bit-identical {same}")
            if not same:
                failures.append(f"{label}{suffix} {dtype}: all-ones bitmap not bit-identical")

    s_len, block = MAIN["cache"], 128
    nb = -(-s_len // block)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for dtype in (torch.bfloat16, torch.float32):
        for case, (n, lengths) in cases.items():
            q, k, v, lens = flash_inputs(torch, n, lengths, dtype)[0]
            bm = (torch.rand((MAIN["batch"], nb), generator=g, device="cuda") < 0.5).to(torch.int32)
            bm[:, 0] = 1
            hold_all(f"{case} random bitmap", q, arms(k, v), lens, bm, block, dtype)
        # policy bitmaps of one layer of each pattern type, for slots at the
        # image positions of the step lengths
        n, lengths = cases["step"]
        q, k, v, lens = flash_inputs(torch, n, lengths, dtype)[0]
        kv_arms = arms(k, v)
        positions = [x - (FLAGSHIP["text_seq_len"] + 1) - 1 for x in lengths]
        for attn_type, bm in zip(PATTERNED[1:], policy_bitmaps(PATTERNED[1:], positions)):
            bm = torch.tensor(bm, device="cuda")
            hold_all(f"step {attn_type} policy bitmap", q, kv_arms, lens, bm, block, dtype)
            # dead tiles are never read: NaN in every dead position (and
            # its scales) leaves the output finite and unchanged
            dead = ~fd.expand_bitmap(bm, block, s_len)[:, None, :, None]
            for suffix, kk, vv, sc in kv_arms:
                clean = fd.block_sparse_flash_decode_attention(q, kk, vv, lens, bm, block, *sc)
                if sc:  # int8 holds no NaN: poison the scales
                    sc = tuple(t.masked_fill(dead[..., 0], float("nan")) for t in sc)
                else:
                    kk, vv = (t.masked_fill(dead, float("nan")) for t in (kk, vv))
                poisoned = fd.block_sparse_flash_decode_attention(q, kk, vv, lens, bm, block, *sc)
                same = torch.equal(clean, poisoned) and bool(torch.isfinite(poisoned).all())
                print(f"check block_sparse_flash_decode poisoned dead tiles {attn_type}{suffix} "
                      f"{str(dtype)[6:]}: finite and unchanged {same}")
                if not same:
                    failures.append(f"poisoned dead tiles {attn_type}{suffix} {dtype} changed the output")
    # the other head dims, small ragged shapes, 32-position blocks
    bm = torch.tensor([[1, 0, 1, 0], [1, 1, 0, 1], [1, 0, 0, 1], [1, 1, 1, 0]],
                      dtype=torch.int32, device="cuda")
    for d in DECODE_OTHER_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for shape in ((4, 2, 5, d), (4, 2, 100, d), (4, 2, 100, d)))
            lens = torch.tensor([5, 37, 64, 100], dtype=torch.int32, device="cuda")
            hold_all(f"D={d} n=5 S=100", q, arms(k, v), lens, bm, 32, dtype)
    torch.cuda.synchronize()
    if failures:
        fail("; ".join(failures))
    return worst


def check_head_dim_limit(torch):
    """Phase 2: head dims above 256 raise on the card, naming ROADMAP Queue
    3, in the decode and flash-attention wrappers alike (no plain version
    runs instead)."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    q = torch.zeros((1, 1, 1, 264), dtype=torch.bfloat16, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    calls = {
        "flash_decode_attention": lambda: fd.flash_decode_attention(q, q, q, lens),
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, q, q),
        "flash_attention_bwd": lambda: fa.flash_attention_bwd(
            q, q, q, q, lens.float()[None, None], lens.float()[None, None]),
    }
    for name, call in calls.items():
        try:
            call()
        except ValueError as exc:
            if "Queue 3" not in str(exc):
                fail(f"{name} at D = 264 raised without naming ROADMAP Queue 3: {exc}")
            print(f"check {name} D=264 raises: {exc}")
            continue
        fail(f"{name} took D = 264 on the card")


def decode_variant_bound(per_pos_bytes, positions, pairs, peaks):
    """(bound_ms, bound_by) of one step (n = 1) at MAIN's shapes: q read
    and out written in bf16, `positions` cache positions read over all
    rows at `per_pos_bytes` per position and head (K and V, and int8's
    two fp32 scales), lengths; 4*D flops per visible (row, key) pair."""
    b, h, d = MAIN["batch"], MAIN["heads"], MAIN["dim_head"]
    nbytes = 2 * b * h * d * 2 + h * per_pos_bytes * positions + 4 * b
    flops = 4 * d * h * pairs
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / peaks["bf16"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_decode_variants(torch, F, peaks, smi, cases):
    """Phase 3 for the new kernels at the step shape in bf16: the int8 arm
    (yardstick: SDPA over the bf16 cache it replaces) and the block-sparse
    kernel with axial_row policy bitmaps (yardstick: SDPA with the
    bitmap-expanded boolean mask)."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    n, lengths = cases["step"]
    b, h, d, s_len = MAIN["batch"], MAIN["heads"], MAIN["dim_head"], MAIN["cache"]
    inputs = flash_inputs(torch, n, lengths, torch.bfloat16, copies=LAYERS)
    int8_in = []
    for q, k, v, lens in inputs:
        kq, vq, ks, vs = quantized(torch, k, v)
        int8_in.append((q, kq, vq, lens, ks, vs))
    live = [min(max(x, 0), s_len) for x in lengths]

    def library_masked(q, k, v, lens, kv_live=None):
        bound = lens.long()[:, None] - n + torch.arange(n, device="cuda")[None, :]
        mask = torch.arange(s_len, device="cuda")[None, None, :] <= bound[:, :, None]
        if kv_live is not None:
            mask = mask & kv_live[:, None, :]
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None])

    iters = 40 * LAYERS
    rows = {}
    row = dict(
        ms=time_ms(torch, fd.flash_decode_attention, int8_in, iters),
        plain_ms=time_ms(torch, fd.flash_decode_attention_plain, int8_in, iters),
        library_ms=time_ms(torch, library_masked, inputs, iters),
    )
    # n = 1: each row's one query sees its `len` keys; int8 K and V (2*D
    # bytes) and two fp32 scales per position and head
    row["bound_ms"], row["bound_by"] = decode_variant_bound(2 * d + 8, sum(live), sum(live), peaks)
    defer_device_time(row, fd.flash_decode_attention, int8_in, iters)
    rows["flash_decode_int8"] = row
    print("time " + json.dumps(dict(
        kernel="flash_decode_int8", case="step", q_dtype="bf16", kv="int8 + fp32 scales",
        lengths=lengths, library="SDPA over the bf16 cache the int8 one replaces",
        card=smi, **row)))

    positions = [x - (FLAGSHIP["text_seq_len"] + 1) - 1 for x in lengths]
    bm = torch.tensor(policy_bitmaps(("axial_row",), positions)[0], device="cuda")
    kv_live = fd.expand_bitmap(bm, 128, s_len)
    sparse_in = [(q, k, v, lens, bm, 128) for q, k, v, lens in inputs]
    lib_in = [(q, k, v, lens, kv_live) for q, k, v, lens in inputs]
    # bytes and flops of the live positions only (visible to the step row)
    in_length = torch.arange(s_len, device="cuda")[None, :] < torch.tensor(live, device="cuda")[:, None]
    visible = in_length & kv_live
    n_visible = int(visible.sum())
    row = dict(
        ms=time_ms(torch, fd.block_sparse_flash_decode_attention, sparse_in, iters),
        plain_ms=time_ms(torch, fd.block_sparse_flash_decode_attention_plain, sparse_in, iters),
        library_ms=time_ms(torch, library_masked, lib_in, iters),
    )
    row["bound_ms"], row["bound_by"] = decode_variant_bound(2 * d * 2, n_visible, n_visible, peaks)
    defer_device_time(row, fd.block_sparse_flash_decode_attention, sparse_in, iters)
    dense_ms = time_ms(torch, fd.flash_decode_attention, inputs, iters)
    rows["block_sparse_flash_decode"] = row
    print("time " + json.dumps(dict(
        kernel="block_sparse_flash_decode", case="step", dtype="bf16", lengths=lengths,
        bitmap="axial_row policy at image positions " + str(positions),
        live_positions=n_visible, length_skip_positions=sum(live),
        flash_decode_ms_same_inputs=dense_ms,
        library="SDPA with the bitmap-expanded boolean mask", card=smi, **row)))
    return rows


# ------------------------------------------------------------ paged kernels

PAGE = 32  # the paged engine's page size
PAGE_SIZES = (16, 32, 64, 128)
PAGED_POOL = 206  # the flagship paged engine's default pool: 4 x 41 + 1 + 41


def paged_case(torch, b, h, n, d, page, lengths, dtype, vlen, seed, n_pool=None):
    """(q, k_pages, v_pages, lengths, table, live) on the card: a pool of
    random pages (page 0, the garbage page, included), each row's blocks
    at shuffled pages, rows 1 and 2 sharing row 0's first pages; `live`
    [P, page] marks the (page, offset) slots some row can see."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = -(-vlen // page)
    n_pool = n_pool or 1 + b * n_pages
    perm = torch.randperm(n_pool - 1, generator=g, device="cuda")[: b * n_pages] + 1
    table = perm.view(b, n_pages).to(torch.int32)
    share = min(2, n_pages)
    table[1:3, :share] = table[0, :share]
    q = torch.randn((b, h, n, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((n_pool, h, page, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens, table, paged_live(torch, table, lengths, page, n_pool)


def paged_live(torch, table, lengths, page, n_pool, page_bitmap=None):
    """[P, page] bool: (page, offset) slots visible to some row, through
    its table, under its length and (when given) its page bitmap."""
    live = torch.zeros((n_pool, page), dtype=torch.bool)
    rows = table.tolist()
    for b, length in enumerate(lengths):
        for j in range(-(-length // page)):
            if page_bitmap is None or page_bitmap[b][j]:
                live[rows[b][j], : min(page, length - j * page)] = True
    return live.to("cuda")


def poisoned(torch, kk, vv, sc, live):
    """The pool with NaN in every slot `live` leaves out (in the scales of
    an int8 pool, whose values hold no NaN)."""
    dead = ~live[:, None, :]
    if sc:
        return kk, vv, tuple(t.masked_fill(dead, float("nan")) for t in sc)
    return kk.masked_fill(dead[..., None], float("nan")), vv.masked_fill(dead[..., None], float("nan")), ()


def check_paged_variants(torch):
    """Phase 2 for kernels 4 and 5 (both arms, bf16 and fp32): against the
    plain versions; bit for bit, the all-ones page bitmap against kernel
    4, kernel 4 against kernel 1 on the `paged_gather` view and kernel 5
    against kernel 3 on that view at block_k = page; and a pool poisoned
    with NaN everywhere no row may read (page 0, unmapped pages, pages
    past each row's last, tails of live pages past the length, dead
    pages) giving finite, unchanged outputs. Returns ({kernel: worst bf16
    max_abs_err}, {identity: cases held})."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    worst = {"paged_flash_decode": 0.0, "block_sparse_paged_flash_decode": 0.0}
    held = {"all-ones page bitmap vs kernel 4": 0, "kernel 4 vs kernel 1 on the gathered view": 0,
            "kernel 5 vs kernel 3 on the gathered view": 0, "poisoned pool unchanged": 0}
    failures = []

    def hold(kernel, label, out, ref, dtype):
        err = (out.float() - ref.float()).abs().max().item()
        tol = decode_tol(torch, ref, dtype)
        if not (err <= tol and torch.isfinite(out).all()):
            failures.append(f"{kernel} {label}: {err:.3e} over {tol:.3e}")
        if dtype == torch.bfloat16:
            worst[kernel] = max(worst[kernel], err)
        return err

    def same(name, label, a, b):
        ok = torch.equal(a, b) and bool(torch.isfinite(a).all())
        if ok:
            held[name] += 1
        else:
            failures.append(f"{label}: {name} failed (max_abs_err "
                            f"{(a.float() - b.float()).abs().max().item():.1e})")

    cases = [(4, 16, 1, 64, 1281, [257, 700, 1024, 1281])]  # the flagship step
    cases += [(4, 2, 5, d, 100, [5, 33, 65, 100]) for d in (16, 32, 40, 48, 128, 256)]
    cases += [(4, 2, 1, d, 700, [1, 255, 256, 700]) for d in (40, 200)]  # split-K at other D
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for b, h, n, d, vlen, lengths in cases:
        for page in PAGE_SIZES:
            n_pages = -(-vlen // page)
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, lens, table, live = paged_case(torch, b, h, n, d, page, lengths, dtype, vlen, SEED + page + d)
                kq, vq, ks, vs = quantized(torch, k, v)
                bm = (torch.rand((b, n_pages), generator=g, device="cuda") < 0.5).to(torch.int32)
                bm[:, : min(2, n_pages)] = 1  # the shared pages stay live
                sparse_live = paged_live(torch, table, lengths, page, k.shape[0], bm.tolist())
                errs = []
                for arm, kk, vv, sc in (("", k, v, ()), (" int8", kq, vq, (ks, vs))):
                    label = f"D={d} n={n} page={page} {str(dtype)[6:]}{arm}"
                    out4 = fd.paged_flash_decode_attention(q, kk, vv, lens, table, *sc)
                    errs.append(hold("paged_flash_decode", label, out4,
                                     fd.paged_flash_decode_attention_plain(q, kk, vv, lens, table, *sc), dtype))
                    out5 = fd.block_sparse_paged_flash_decode_attention(q, kk, vv, lens, table, bm, *sc)
                    errs.append(hold("block_sparse_paged_flash_decode", label, out5,
                                     fd.block_sparse_paged_flash_decode_attention_plain(
                                         q, kk, vv, lens, table, bm, *sc), dtype))
                    ones = torch.ones_like(bm)
                    same("all-ones page bitmap vs kernel 4", label,
                         fd.block_sparse_paged_flash_decode_attention(q, kk, vv, lens, table, ones, *sc), out4)
                    kg, vg = fd.paged_gather(kk, table, vlen), fd.paged_gather(vv, table, vlen)
                    scg = tuple(fd.paged_gather(t, table, vlen) for t in sc)
                    same("kernel 4 vs kernel 1 on the gathered view", label,
                         out4, fd.flash_decode_attention(q, kg, vg, lens, *scg))
                    same("kernel 5 vs kernel 3 on the gathered view", label,
                         out5, fd.block_sparse_flash_decode_attention(q, kg, vg, lens, bm, page, *scg))
                    pk, pv, psc = poisoned(torch, kk, vv, sc, live)
                    same("poisoned pool unchanged", label + " causal",
                         fd.paged_flash_decode_attention(q, pk, pv, lens, table, *psc), out4)
                    pk, pv, psc = poisoned(torch, kk, vv, sc, sparse_live)
                    same("poisoned pool unchanged", label + " sparse",
                         fd.block_sparse_paged_flash_decode_attention(q, pk, pv, lens, table, bm, *psc), out5)
                print(f"check paged D={d} n={n} page={page} {str(dtype)[6:]} lengths={lengths}: "
                      f"max_abs_err kernel 4 / 5, plain and int8: " + ", ".join(f"{e:.2e}" for e in errs))
    torch.cuda.synchronize()
    print("check paged bit identities (cases held): " + json.dumps(held))
    if failures:
        fail("paged kernels: " + "; ".join(failures[:10]))
    return worst, held


def paged_bound(lengths, page, visible, peaks):
    """(bound_ms, bound_by) of one paged step (n = 1) at MAIN's widths in
    bf16: q read and out written, the `visible` K/V positions read once,
    the table entries of the pages they lie on, lengths; 4*D flops per
    visible key."""
    b, h, d = MAIN["batch"], MAIN["heads"], MAIN["dim_head"]
    table = sum(-(-x // page) for x in lengths) * 4
    nbytes = 2 * b * h * d * 2 + h * 2 * d * 2 * visible + table + 4 * b
    flops = 4 * d * h * visible
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / peaks["bf16"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_paged_variants(torch, F, peaks, smi, cases):
    """Phase 3 for kernels 4 and 5 at the flagship step in bf16 (n = 1, B
    = 4, H = 16, D = 64, page 32, a shuffled 206-page pool, LAYERS copies
    rotating): kernel, plain, library (SDPA over the cache gathered
    beforehand, the gather not timed) and the reference-default gather
    impl (paged_gather + kernel 1); kernel 5 with the axial_row policy's
    bitmap re-expanded to pages."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    n, lengths = cases["step"]
    vlen = MAIN["cache"]
    sets = [paged_case(torch, MAIN["batch"], MAIN["heads"], n, MAIN["dim_head"], PAGE, lengths,
                       torch.bfloat16, vlen, SEED + i, n_pool=PAGED_POOL)[:5] for i in range(LAYERS)]
    gathered = [(q, fd.paged_gather(k, t, vlen), fd.paged_gather(v, t, vlen), lens) for q, k, v, lens, t in sets]
    int8_sets = []
    for q, k, v, lens, t in sets:
        kq, vq, ks, vs = quantized(torch, k, v)
        int8_sets.append((q, kq, vq, lens, t, ks, vs))

    def library(q, k, v, lens, kv_live=None):
        mask = torch.arange(vlen, device="cuda")[None, :] < lens.long()[:, None]
        if kv_live is not None:
            mask = mask & kv_live
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None])

    def gather_impl(q, k, v, lens, t, *rest):
        return fd.paged_decode_attention(q, k, v, lens, t, vlen, "gather", *rest)

    iters = 40 * LAYERS
    rows = {}
    row = dict(
        ms=time_ms(torch, fd.paged_flash_decode_attention, sets, iters),
        plain_ms=time_ms(torch, fd.paged_flash_decode_attention_plain, sets, iters),
        library_ms=time_ms(torch, library, gathered, iters),
    )
    live = sum(lengths)
    row["bound_ms"], row["bound_by"] = paged_bound(lengths, PAGE, live, peaks)
    defer_device_time(row, fd.paged_flash_decode_attention, sets, iters)
    extra = dict(
        gather_impl_ms=time_ms(torch, gather_impl, sets, iters),
        kernel1_on_gathered_ms=time_ms(torch, fd.flash_decode_attention, gathered, iters),
        int8_ms=time_ms(torch, fd.paged_flash_decode_attention, int8_sets, iters),
        int8_gather_impl_ms=time_ms(torch, gather_impl, int8_sets, iters),
    )
    rows["paged_flash_decode"] = row
    print("time " + json.dumps(dict(
        kernel="paged_flash_decode", case="step", dtype="bf16", page=PAGE, pool_pages=PAGED_POOL,
        lengths=lengths, library="SDPA over the cache gathered beforehand (gather not timed)",
        card=smi, **row, **extra)))

    positions = [x - (FLAGSHIP["text_seq_len"] + 1) - 1 for x in lengths]
    n_pages = -(-vlen // PAGE)
    bm = fd.page_bitmap(torch.tensor(policy_bitmaps(("axial_row",), positions)[0], device="cuda"),
                        128, PAGE, n_pages)
    kv_live = fd.expand_bitmap(bm, PAGE, vlen)
    sparse_in = [(q, k, v, lens, t, bm) for q, k, v, lens, t in sets]
    visible = int((kv_live & (torch.arange(vlen, device="cuda")[None, :]
                              < torch.tensor(lengths, device="cuda")[:, None])).sum())
    row = dict(
        ms=time_ms(torch, fd.block_sparse_paged_flash_decode_attention, sparse_in, iters),
        plain_ms=time_ms(torch, fd.block_sparse_paged_flash_decode_attention_plain, sparse_in, iters),
        library_ms=time_ms(torch, library, [g + (kv_live,) for g in gathered], iters),
    )
    row["bound_ms"], row["bound_by"] = paged_bound(lengths, PAGE, visible, peaks)
    defer_device_time(row, fd.block_sparse_paged_flash_decode_attention, sparse_in, iters)
    sparse_int8 = [(q, kq, vq, lens, t, bm, ks, vs) for q, kq, vq, lens, t, ks, vs in int8_sets]
    extra = dict(
        int8_ms=time_ms(torch, fd.block_sparse_paged_flash_decode_attention, sparse_int8, iters),
        kernel4_same_inputs_ms=rows["paged_flash_decode"]["ms"],
    )
    rows["block_sparse_paged_flash_decode"] = row
    print("time " + json.dumps(dict(
        kernel="block_sparse_paged_flash_decode", case="step", dtype="bf16", page=PAGE,
        bitmap="axial_row policy at image positions " + str(positions) + ", re-expanded to pages",
        live_positions=visible, length_skip_positions=live,
        library="SDPA with the page-expanded mask over the cache gathered beforehand",
        card=smi, **row, **extra)))
    return rows


PROMPTS = (
    "a red apple on a wooden table",
    "a lighthouse on a cliff at dusk",
    "an armchair in the shape of an avocado",
    "a small boat on a calm lake",
)


def flagship_engine():
    """(engine, specs, DALLE parameter count): the micro GenerationEngine at
    the flagship width on the card, random weights from SEED, bfloat16,
    batch shape 4, the dVAE fused, and one sampling spec per prompt."""
    import torch

    from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
    from dalle_pytorch_tpu_torch.serving.engine import GenerationEngine, SampleSpec

    torch.manual_seed(SEED)
    with torch.device("cuda"):
        model = DALLE(**FLAGSHIP)
        vae = DiscreteVAE(
            image_size=256, num_layers=3, num_tokens=8192, codebook_dim=512, hidden_dim=64
        )
    n_params = sum(p.numel() for p in model.parameters())
    engine = GenerationEngine(
        model.to(torch.bfloat16), vae.to(torch.bfloat16), batch_shapes=(4,),
        tokenizer=ByteTokenizer(), device="cuda",
    )
    specs = [
        SampleSpec(engine.tokenize(p), seed=100 + i, temperature=1.0, top_k=0.9)
        for i, p in enumerate(PROMPTS)
    ]
    return engine, specs, n_params


def attention_case(torch, label, b, h, n_q, n_k, d, dtype, mask=None, seed=SEED, causal=True):
    """Each flash-attention kernel against its plain version on the same
    inputs (the kernels run first, so no buffer can hold a plain result),
    under ATTN_TOL; bf16 against both the exact and the rounding-matched
    plain version. The backward takes the kernel forward's lse and delta,
    and runs twice: dk and dv must be bit-identical (no atomics), dq's
    run-to-run difference (the order of its atomic adds) is printed.
    Returns {kernel: max_abs_err against the exact version}."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(b, h, n_q, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, h, n_k, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    fm = None if mask is None else fa.flash_mask(mask, "cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, fm, causal)
    delta = (do.float() * o.float()).sum(-1)
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, fm, causal)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, fm, causal)
    torch.cuda.synchronize()
    outs = {"fwd": (o, lse), "bwd": grads}
    dq_rerun = (grads[0].float() - again[0].float()).abs().max().item()
    if not (torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])):
        fail(f"flash_attention_bwd {label} {dtype}: dk or dv differ between two runs")

    def plain(p_dtype):
        return {
            "fwd": fa.flash_attention_forward_plain(q, k, v, fm, causal, p_dtype=p_dtype),
            "bwd": fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, fm, causal,
                                                p_dtype=p_dtype),
        }

    refs = {"exact": plain(None)}
    if dtype == torch.bfloat16:
        refs["matched"] = plain(torch.bfloat16)
    errs, report, failures = {}, [], []
    for kind, outputs in outs.items():
        name = f"flash_attention_{kind}"
        for ref_kind, ref in refs.items():
            for i, (out, r) in enumerate(zip(outputs, ref[kind])):
                tensor = ("o", "lse", "dq", "dk", "dv")[{"fwd": 0, "bwd": 2}[kind] + i]
                if dtype == torch.float32 or tensor == "lse":
                    tol_key = "fp32"
                elif ref_kind == "exact":
                    tol_key = "bf16_exact"
                else:
                    tol_key = "bf16_matched_p" if tensor in ("o", "dv") else "bf16_matched_ds"
                err, element, tile = attention_closeness(torch, out, r)
                el_tol, tile_tol = ATTN_TOL[tol_key]
                report.append(f"{tensor}/{ref_kind} {element:.1e} {tile:.1e}")
                if not ((el_tol is None or element <= el_tol) and tile <= tile_tol):
                    failures.append(
                        f"{name} {tensor} vs the {ref_kind} plain version: element "
                        f"{element:.3e}, tile {tile:.3e} over {tol_key} {ATTN_TOL[tol_key]}"
                    )
                if ref_kind == "exact":
                    errs[name] = max(errs.get(name, 0.0), err)
    print(
        f"check flash_attention {label} {str(dtype)[6:]} B={b} H={h} nq={n_q} nk={n_k} D={d}: "
        + ", ".join(f"{k[16:]} {e:.3e}" for k, e in errs.items())
        + f" max_abs_err; dk, dv bit-identical over two runs, dq run-to-run {dq_rerun:.3e}"
        + "; element, tile ratios: " + "; ".join(report)
    )
    if failures:
        fail(f"flash_attention {label} {dtype}: " + "; ".join(failures))
    return errs


def check_attention(torch):
    """Phase 2 for flash attention; returns {kernel: worst bf16 error}."""
    import numpy as np

    from dalle_pytorch_tpu_torch.models.transformer import build_static_mask

    b, h, n, d = TRAIN["batch"], TRAIN["heads"], TRAIN["n"], TRAIN["dim_head"]
    axial = np.tril(np.ones((n, n), bool)) & build_static_mask("axial_row", n, 32, 1)[:n, :n]
    print(f"check flash_attention limits (element, tile): {json.dumps(ATTN_TOL)}")
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases = [
            ("causal", b, h, n, n, d, None),
            ("ragged", b, h, 1000, 1000, d, None),
            ("axial_row", b, h, n, n, d, axial),
            ("nk>nq", 2, 2, 70, 150, d, None),
            ("all keys", 2, 2, 100, 150, d, None),  # the arm without causality or mask
        ] + [("small", 2, 2, 100, 100, dd, None) for dd in ATTENTION_OTHER_DIMS]
        for label, *shape, mask in cases:
            errs = attention_case(torch, label, *shape, dtype, mask=mask,
                                  causal=label != "all keys")
            if dtype == torch.bfloat16:
                for kernel, err in errs.items():
                    worst[kernel] = max(worst.get(kernel, 0.0), err)
    return worst


def time_attention(torch, F, peaks, dtype, key, elt, d=TRAIN["dim_head"]):
    """Kernel, plain and library times of the two passes at TRAIN's causal
    shapes (head dim `d`; inputs rotate over 3 copies). SDPA's backward
    computes dq, dk and dv in one call, its own delta included, so beside
    the backward kernel the row also times the port's whole backward as
    the autograd Function runs it (delta, then the wrapper: workspace
    zeroing, the kernel, dq's conversion). The bf16 rows' device times are
    taken after phase 8."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    b, h, n = TRAIN["batch"], TRAIN["heads"], TRAIN["n"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sets, whole_in = [], []
    for _ in range(3):
        q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
        whole_in.append((q, k, v, o, lse, do))
    fwd_in = [s[:3] for s in sets]
    lib_bwd_in = []
    for q, k, v, do, _, _ in sets:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        lib_bwd_in.append((out, *leaves, do))

    def lib_fwd(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def lib_bwd(out, q, k, v, do):
        return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)

    def whole_bwd(q, k, v, o, lse, do):  # _FlashAttention.backward's body
        delta = (do.float() * o.float()).sum(dim=-1)
        return fa.flash_attention_bwd(q, k, v, do, lse, delta)

    rows = {
        "flash_attention_fwd": dict(
            ms=time_ms(torch, fa.flash_attention_fwd, fwd_in, 30),
            plain_ms=time_ms(torch, fa.flash_attention_forward_plain, fwd_in, 6),
            library_ms=time_ms(torch, lib_fwd, fwd_in, 30),
        ),
        "flash_attention_bwd": dict(
            ms=time_ms(torch, fa.flash_attention_bwd, sets, 30),
            plain_ms=time_ms(torch, fa.flash_attention_bwd_plain, sets, 6),
            library_ms=time_ms(torch, lib_bwd, lib_bwd_in, 30),
            whole_backward_ms=time_ms(torch, whole_bwd, whole_in, 30),
        ),
    }
    if dtype == torch.bfloat16:
        defer_device_time(rows["flash_attention_fwd"], fa.flash_attention_fwd, fwd_in, 30)
        defer_device_time(rows["flash_attention_bwd"], fa.flash_attention_bwd, sets, 30)
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = attention_bound(name[16:], elt, peaks, key, d)
        print("time " + json.dumps(dict(kernel=name, dtype=key, B=b, H=h, N=n, D=d, causal=True, **row)))
    bwd = rows["flash_attention_bwd"]
    print(
        f"time flash_attention backward {key}: kernel {bwd['ms']:.4f} ms, whole backward "
        f"{bwd['whole_backward_ms']:.4f} ms, SDPA backward {bwd['library_ms']:.4f} ms, "
        f"bound {bwd['bound_ms']:.4f} ms"
    )
    return rows


def check_small_model_training(torch):
    """Phase 4, training: a small float32 DALLE (full + axial_row layers,
    n = 80, two 64-row tiles) through the flash kernels and through dense
    attention, same weights: loss and every gradient of the
    forward_reverse_partial objective within 1e-4."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.training.steps import accumulate_gradients, make_dalle_loss

    small = dict(
        dim=128, depth=2, heads=2, dim_head=64, num_image_tokens=64, image_fmap_size=8,
        num_text_tokens=100, text_seq_len=16, attn_types=("full", "axial_row"),
    )
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        models = [DALLE(**small, attn_impl=impl) for impl in ("flash", "dense")]
    models[1].load_state_dict(models[0].state_dict())
    g = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {
        "text": torch.randint(1, 100, (2, 16), generator=g, device="cuda"),
        "image_tokens": torch.randint(0, 64, (2, 64), generator=g, device="cuda"),
    }
    results = []
    for m in models:
        metrics = accumulate_gradients(m, make_dalle_loss(m, "forward_reverse_partial"), batch)
        results.append((metrics["loss"].item(), [p.grad for p in m.parameters()]))
    loss_err = abs(results[0][0] - results[1][0])
    grad_err = max((a - b).abs().max().item() for a, b in zip(results[0][1], results[1][1]))
    print(
        f"check model fp32 training kernel-vs-dense (forward_reverse_partial): loss "
        f"{results[0][0]:.6f} err {loss_err:.3e}, worst gradient err {grad_err:.3e}, tol 1e-4"
    )
    if not (loss_err <= 1e-4 and grad_err <= 1e-4):
        fail("the small model's training loss or gradients disagree between kernels and dense")


def flagship_training():
    """(DALLE, batch): the flagship DALLE on the card with float32
    parameters from SEED, attn_impl "auto", and a batch of 4 seeded text
    and image-token rows (text padded from position 200)."""
    import numpy as np
    import torch

    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    torch.manual_seed(SEED)
    with torch.device("cuda"):
        model = DALLE(**FLAGSHIP, attn_impl="auto")
    rng = np.random.RandomState(SEED)
    text = rng.randint(1, FLAGSHIP["num_text_tokens"], (4, FLAGSHIP["text_seq_len"]))
    text[:, 200:] = 0  # padding: the unique pad ids
    image = rng.randint(0, FLAGSHIP["num_image_tokens"], (4, 1024))
    batch = {
        "text": torch.tensor(text, device="cuda"),
        "image_tokens": torch.tensor(image, device="cuda"),
    }
    return model, batch


def run_training(torch, vae, specs):
    """Phase 6: (launches per kernel over the 5 timed steps, summary)."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention
    from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint
    from dalle_pytorch_tpu_torch.training.pipeline import (
        dalle_config,
        dvae_hparams,
        save_dalle_checkpoint,
    )
    from dalle_pytorch_tpu_torch.training.steps import make_dalle_train_step, make_optimizer
    from dalle_pytorch_tpu_torch.weights import export_dvae_params

    model, batch = flagship_training()
    with torch.no_grad():
        loss32 = model(batch["text"], batch["image_tokens"], return_loss=True)[0].item()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss16 = model(batch["text"], batch["image_tokens"], return_loss=True)[0].item()
    # bf16 rounds every product's inputs (2^-9 relative); the residual
    # stream, LayerNorm and the loss stay float32, and the loss averages
    # 5120 positions, so the roundings mostly cancel: on an H100 the gap
    # was 2.9e-5 (3e-6 relative); 2e-4 relative leaves 60x room
    tol = 2e-4 * abs(loss32)
    print(f"check training step-0 loss: fp32 {loss32:.6f}, bf16 autocast {loss16:.6f}, tol {tol:.4f}")
    if not abs(loss16 - loss32) <= tol:
        fail("the bf16 loss disagrees with the fp32 loss of the same weights")

    opt = make_optimizer(model.parameters(), 3e-4, clip_grad_norm=0.5)
    step = make_dalle_train_step(model, opt, mode="forward_only", autocast_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(5)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    losses = [m["loss"].item() for m in metrics]
    tokens = 5 * 4 * model.total_seq_len
    summary = dict(
        ms_per_step=1e3 * wall / 5, tokens_per_s=tokens / wall, warmup_step_s=warm_s,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, losses=losses,
        grad_norms=[m["grad_norm"].item() for m in metrics], launches=launches,
    )
    print("training " + json.dumps(summary))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"the training loss is not finite or did not fall: {losses}")
    for name, n in launches.items():
        if n != LAYERS * 5:
            fail(f"{name} launched {n} times in 5 steps, expected {LAYERS * 5}")

    # train -> checkpoint -> serve
    ckpt_dir = REPO / "build" / "chip_smoke"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / "dalle_trained.npz"
    t0 = time.perf_counter()
    save_dalle_checkpoint(
        str(path), dalle_config(model, bf16=True), model,
        vae_params=export_dvae_params(vae), vae_hparams=dvae_hparams(vae),
    )
    del model, opt, step
    engine = engine_from_checkpoint(str(path), batch_shapes=(4,), device="cuda")
    ckpt_s = time.perf_counter() - t0
    path.unlink()
    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    toks, pixels = engine.generate(specs)
    gen_s = time.perf_counter() - t0
    decode_launches = flash_decode_attention.launches
    print(
        f"checkpoint -> engine: save + load {ckpt_s:.2f} s; generate {gen_s:.3f} s, "
        f"flash_decode launches {decode_launches}"
    )
    if decode_launches != LAYERS * (1 + engine.image_seq_len):
        fail(f"the trained checkpoint's engine launched flash_decode {decode_launches} times")
    if toks.shape != (4, 1024) or toks.min() < 0 or toks.max() >= 8192:
        fail(f"trained checkpoint tokens out of range or shape {toks.shape}")
    if pixels.shape != (4, 256, 256, 3) or not math.isfinite(float(pixels.sum())):
        fail(f"trained checkpoint pixels not finite or shape {pixels.shape}")
    return launches, summary


CONTINUOUS = dict(max_batch=4, prefill_batch=4, chunk_tokens=4)


def serve_continuous(torch, model, vae, specs, label, **options):
    """Phase 7, one run: a warmed ContinuousEngine over `model` behind the
    ContinuousBatcher; the first two prompts are submitted, the other two
    once 8 chunks have run (admitted mid-flight). Returns (engine, tokens,
    pixels, {kernel: launches}, expected launches of the path's kernel)."""
    import numpy as np

    from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd
    from dalle_pytorch_tpu_torch.serving.batcher import ContinuousBatcher
    from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine

    engine = ContinuousEngine(
        model, vae, **CONTINUOUS, tokenizer=ByteTokenizer(), device="cuda", **options
    )
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    counters = {
        "flash_decode": (fd.flash_decode_attention, "launches"),
        "flash_decode_int8": (fd.flash_decode_attention, "int8_launches"),
        "block_sparse_flash_decode": (fd.block_sparse_flash_decode_attention, "launches"),
        "block_sparse_flash_decode_int8": (fd.block_sparse_flash_decode_attention, "int8_launches"),
    }
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(engine)
    t0 = time.perf_counter()
    reqs = [batcher.submit([sp]) for sp in specs[:2]]
    while engine.stats.chunks < 8 and not all(r.future.done() for r in reqs):
        time.sleep(0.002)
    reqs += [batcher.submit([sp]) for sp in specs[2:]]
    outs = [r.future.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    batcher.shutdown()
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    chunks, waves = engine.stats.chunks, engine.stats.prefill_dispatches
    expected = engine.model.depth * (CONTINUOUS["chunk_tokens"] * chunks + waves)
    toks = np.concatenate([o[0] for o in outs])
    pixels = np.concatenate([o[1] for o in outs])
    print("continuous " + json.dumps(dict(
        run=label, wall_s=wall, images_per_s=len(specs) / wall, warmup_s=warm_s,
        chunks=chunks, prefill_waves=waves, ms_per_chunk=1e3 * wall / chunks,
        launches=launches, expected_launches=expected,
        kv_bytes_per_slot=engine.kv_bytes_per_slot(), sparsity=engine.sparsity_detail(),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
    )))
    if toks.shape != (4, 1024) or toks.min() < 0 or toks.max() >= 8192:
        fail(f"continuous {label}: tokens out of range or shape {toks.shape}")
    if pixels.shape != (4, 256, 256, 3) or not math.isfinite(float(pixels.sum())):
        fail(f"continuous {label}: pixels not finite or shape {pixels.shape}")
    return engine, toks, pixels, launches, expected


SHORT_DEPTH = 4  # phase 7's int8 and policy runs: depth cut to hold the script's time


def first_layers(torch, model, depth):
    """A DALLE of `depth` layers on the card holding `model`'s embeddings,
    head and first `depth` layers (bfloat16, eval)."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    with torch.device("cuda"):
        short = DALLE(**{**FLAGSHIP, "depth": depth})
    own = short.state_dict()
    short.load_state_dict({k: v for k, v in model.state_dict().items() if k in own})
    return short.to(torch.bfloat16).eval()


def run_continuous(torch, model, vae, specs, micro_tokens):
    """Phase 7: the four runs. Returns ({kernel: launches on its run}, the
    causal run's tokens, the patterned model and its policy + int8
    tokens)."""
    import copy

    import numpy as np

    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.serving.engine import GenerationEngine

    def only(launches, kernel, expected, label):
        others = {k: n for k, n in launches.items() if k != kernel and n}
        if launches[kernel] != expected or others:
            fail(f"continuous {label}: {kernel} launched {launches[kernel]} times "
                 f"(expected {expected}), others {others}")

    # 1. causal: the micro engine's tokens, and a chunk with no host sync
    engine, toks1, _, launches, expected = serve_continuous(torch, model, vae, specs, "causal")
    same = np.array_equal(toks1, micro_tokens)
    print(f"check continuous causal tokens identical to phase 5's micro engine: {same} "
          f"(agreement {(toks1 == micro_tokens).mean():.6f})")
    if not same:
        fail("the continuous engine's tokens differ from the micro engine's")
    only(launches, "flash_decode", expected, "causal")
    causal_bytes = engine.kv_bytes_per_slot()
    engine.prefill_slots([(0, specs[0])])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pos, act = engine.chunk_snapshot()
    engine.release([0])
    print(f"check continuous chunk under sync-debug mode 'error': no host sync (slot 0 at {pos[0]})")
    if pos[0] != CONTINUOUS["chunk_tokens"] or not act[0]:
        fail(f"the synced-debug chunk left slot 0 at {pos[0]}, active {act[0]}")
    del engine
    out = {}

    # 2-3. int8 KV and policy on the model's first SHORT_DEPTH layers, held
    # against a causal run of that model
    short = first_layers(torch, model, SHORT_DEPTH)
    engine, toks_short, _, _, _ = serve_continuous(
        torch, short, vae, specs, f"causal depth {SHORT_DEPTH}")
    short_bytes = engine.kv_bytes_per_slot()
    del engine
    engine, toks2, _, launches, expected = serve_continuous(
        torch, short, vae, specs, f"int8 depth {SHORT_DEPTH}", kv_dtype="int8")
    only(launches, "flash_decode_int8", expected, "int8")
    ratio = engine.kv_bytes_per_slot() / short_bytes
    d = FLAGSHIP["dim_head"]
    expected_ratio = (d + 4) / (2 * d)  # int8 values + an fp32 scale vs bf16 values
    print(f"check continuous int8: token agreement with the causal run of its model "
          f"{(toks2 == toks_short).mean():.4f}; kv_bytes_per_slot {engine.kv_bytes_per_slot()} "
          f"vs {short_bytes} = {ratio:.4f} (expected ({d} + 4) / {2 * d} = {expected_ratio:.4f})")
    if abs(ratio - expected_ratio) > 1e-3:
        fail(f"int8 kv_bytes_per_slot ratio {ratio}")
    if causal_bytes != short_bytes * LAYERS // SHORT_DEPTH:
        fail(f"kv_bytes_per_slot {causal_bytes} at depth {LAYERS} vs {short_bytes} at {SHORT_DEPTH}")
    out["flash_decode_int8"] = launches["flash_decode_int8"]
    del engine

    # 3. policy on the unpatterned model: all-ones bitmaps, same bits
    engine, toks3, _, launches, expected = serve_continuous(
        torch, short, vae, specs, f"policy depth {SHORT_DEPTH}", decode_sparsity="policy")
    same = np.array_equal(toks3, toks_short)
    print(f"check continuous policy (all full layers) tokens identical to the causal run of "
          f"its model: {same}")
    if not same:
        fail("policy sparsity on full layers changed the tokens")
    only(launches, "block_sparse_flash_decode", expected, "policy")
    out["block_sparse_flash_decode"] = launches["block_sparse_flash_decode"]
    del engine, short

    # 4. policy + int8 on the patterned flagship
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        patterned = DALLE(**{**FLAGSHIP, "attn_types": PATTERNED}).to(torch.bfloat16).eval()
    engine, toks4, _, launches, expected = serve_continuous(
        torch, patterned, vae, specs, "policy+int8 patterned",
        decode_sparsity="policy", kv_dtype="int8")
    only(launches, "block_sparse_flash_decode_int8", expected, "policy+int8 patterned")
    detail = engine.sparsity_detail()
    if not detail["kv_tiles_skipped"] > 0:
        fail(f"the patterned policy run skipped no tiles: {detail}")
    del engine
    reference = copy.copy(patterned)  # the same weights, int8 KV, dense pattern layers
    reference.kv_dtype = "int8"
    micro = GenerationEngine(reference, vae, batch_shapes=(4,), device="cuda")
    ref_toks, _ = micro.generate(specs)
    print(f"check continuous policy+int8 patterned: token agreement with the micro engine "
          f"(dense pattern layers, int8 KV) {(toks4 == ref_toks).mean():.4f}; tiles read "
          f"{detail['kv_tiles_read']}, skipped {detail['kv_tiles_skipped']} "
          f"({detail['kv_tiles_skipped'] / (detail['kv_tiles_read'] + detail['kv_tiles_skipped']):.3f})")
    out["block_sparse_flash_decode_int8"] = launches["block_sparse_flash_decode_int8"]
    return out, toks1, patterned, toks4


DECODE_COUNTERS = {
    "flash_decode": ("flash_decode_attention", "launches"),
    "flash_decode_int8": ("flash_decode_attention", "int8_launches"),
    "block_sparse_flash_decode": ("block_sparse_flash_decode_attention", "launches"),
    "block_sparse_flash_decode_int8": ("block_sparse_flash_decode_attention", "int8_launches"),
    "paged_flash_decode": ("paged_flash_decode_attention", "launches"),
    "paged_flash_decode_int8": ("paged_flash_decode_attention", "int8_launches"),
    "block_sparse_paged_flash_decode": ("block_sparse_paged_flash_decode_attention", "launches"),
    "block_sparse_paged_flash_decode_int8": ("block_sparse_paged_flash_decode_attention", "int8_launches"),
}


def serve_paged(torch, model, vae, specs, label, **options):
    """Phase 8, one run: a warmed PagedContinuousEngine (page 32) over
    `model` behind the ContinuousBatcher; the first two prompts are
    submitted, then once 8 chunks have run the other two and repeats of
    the first two with their seeds (full-prompt prefix hits). Returns
    (engine, tokens [6, 1024], {kernel: launches}, admission record)."""
    import numpy as np

    from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd
    from dalle_pytorch_tpu_torch.serving.batcher import ContinuousBatcher
    from dalle_pytorch_tpu_torch.serving.engine import PagedContinuousEngine

    engine = PagedContinuousEngine(
        model, vae, **CONTINUOUS, page_size=PAGE, tokenizer=ByteTokenizer(), device="cuda", **options
    )
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    for fn, attr in DECODE_COUNTERS.values():
        setattr(getattr(fd, fn), attr, 0)
    waves = []  # per prefill_slots call: its admission stats and the rows live after it
    admit = engine.prefill_slots

    def recording(assignments):
        admit(assignments)
        waves.append(dict(engine.last_admission_stats,
                          live_rows=int(engine._state["host"]["active"].sum())))

    engine.prefill_slots = recording
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(engine)
    t0 = time.perf_counter()
    reqs = [batcher.submit([sp]) for sp in specs[:2]]
    while engine.stats.chunks < 8 and not all(r.future.done() for r in reqs):
        time.sleep(0.002)
    reqs += [batcher.submit([sp]) for sp in specs[2:] + specs[:2]]
    outs = [r.future.result(900) for r in reqs]
    wall = time.perf_counter() - t0
    batcher.shutdown()
    launches = {name: getattr(getattr(fd, fn), attr) for name, (fn, attr) in DECODE_COUNTERS.items()}
    toks = np.concatenate([o[0] for o in outs])
    pixels = np.concatenate([o[1] for o in outs])
    detail = engine.kv_detail()
    chunks = engine.stats.chunks
    print("paged " + json.dumps(dict(
        run=label, wall_s=wall, images_per_s=len(reqs) / wall, warmup_s=warm_s, chunks=chunks,
        ms_per_chunk=1e3 * wall / chunks, prefill_dispatches=engine.stats.prefill_dispatches,
        waves=waves, launches={k: n for k, n in launches.items() if n},
        kv_bytes_per_page=engine.kv_page_bytes(), kv_bytes_per_slot=engine.kv_bytes_per_slot(),
        kv_pages=engine.kv_pages, peak_pages_allocated=engine.kv.pool.peak_allocated,
        pages=detail, sparsity=engine.sparsity_detail(),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
    )))
    if toks.shape != (6, 1024) or toks.min() < 0 or toks.max() >= 8192:
        fail(f"paged {label}: tokens out of range or shape {toks.shape}")
    if pixels.shape != (6, 256, 256, 3) or not math.isfinite(float(pixels.sum())):
        fail(f"paged {label}: pixels not finite or shape {pixels.shape}")
    return engine, toks, launches, waves


def check_paged_run(engine, toks, launches, waves, label, kernel, decode_kernel, reference):
    """Phase 8 checks common to the runs: the four requests' tokens equal
    `reference`, each repeat its first occurrence; the two repeats were
    full-prompt hits admitted with no prefill dispatch; `kernel` (each
    chunk step's, in every layer) and `decode_kernel` (each prefill's)
    are the only kernels launched, exactly as often as the run's chunks
    and prefill dispatches need; the pool is consistent after the drain."""
    import numpy as np

    same = np.array_equal(toks[:4], reference) and np.array_equal(toks[4:], toks[:2])
    hits = sum(w["prefix_hits"] for w in waves)
    dispatches = engine.stats.prefill_dispatches
    miss_waves = sum(1 for w in waves if w["prefix_hits"] < w["wave_rows"])
    depth = engine.model.depth
    expected = {kernel: depth * CONTINUOUS["chunk_tokens"] * engine.stats.chunks}
    expected[decode_kernel] = expected.get(decode_kernel, 0) + depth * dispatches
    others = {k: n for k, n in launches.items() if n and k not in expected}
    leaks = engine.kv.leak_check()
    print(f"check paged {label}: tokens identical to the reference and repeats to their first "
          f"occurrence {same}; prefix hits {hits} with prefill dispatches {dispatches} for "
          f"{miss_waves} waves holding misses; launches {launches[kernel]} {kernel}, "
          f"{launches[decode_kernel]} {decode_kernel} (expected {expected}), others {others}; "
          f"leak_check {leaks}")
    if not same:
        fail(f"paged {label}: tokens differ from the reference")
    if hits != 2 or dispatches != miss_waves or sum(w["dispatches"] for w in waves) != dispatches:
        fail(f"paged {label}: prefix hits {hits}, dispatches {dispatches}, waves {waves}")
    if any(launches[k] != n for k, n in expected.items()) or others:
        fail(f"paged {label}: launches {launches}, expected {expected}")
    if leaks:
        fail(f"paged {label}: leak_check {leaks}")


def run_paged(torch, model, patterned, vae, specs, causal_tokens, patterned_tokens):
    """Phase 8: the three runs of the flagship PagedContinuousEngine.
    Returns {kernel: launches on its run} for kernels 4 and 5."""
    # 1. the reference's default impl: paged_gather + kernel 1
    engine, toks1, launches, waves = serve_paged(torch, model, vae, specs, "gather causal",
                                                 paged_decode_impl="gather")
    check_paged_run(engine, toks1, launches, waves, "gather causal", "flash_decode", "flash_decode",
                    causal_tokens)
    del engine

    # 2. kernel 4, with a pool of two rows' worst case beside the prefix
    # cache's four entries (8 full pages and a snapshot page each)
    per_row = -(-(FLAGSHIP["text_seq_len"] + 1024 + 1) // PAGE)  # 41
    text_pages = -(-(FLAGSHIP["text_seq_len"] + 1) // PAGE)  # 9: 8 full and the snapshot
    kv_pages = 1 + 2 * per_row + len(PROMPTS) * text_pages
    engine, toks2, launches, waves = serve_paged(torch, model, vae, specs, "kernel causal, small pool",
                                                 paged_decode_impl="kernel", kv_pages=kv_pages)
    check_paged_run(engine, toks2, launches, waves, "kernel causal, small pool", "paged_flash_decode",
                    "flash_decode", toks1[:4])
    held_back = max(w["live_rows"] for w in waves)
    print(f"check paged small pool ({kv_pages} pages): at most {held_back} rows live of "
          f"{CONTINUOUS['max_batch']} slots; every request completed")
    if held_back != 2:
        fail(f"the small pool let {held_back} rows live at once")
    out = {"paged_flash_decode": launches["paged_flash_decode"]}
    # one chunk (a prefix hit's first) under sync-debug "error": no host sync
    engine.prefill_slots([(0, specs[0])])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pos, act = engine.chunk_snapshot()
    engine.release([0])
    print(f"check paged chunk under sync-debug mode 'error': no host sync (slot 0 at {pos[0]})")
    if pos[0] != CONTINUOUS["chunk_tokens"] or not act[0] or engine.kv.leak_check():
        fail(f"the synced-debug paged chunk left slot 0 at {pos[0]}, active {act[0]}")
    del engine

    # 3. kernel 5's int8 arm with real holes on the patterned model
    engine, toks3, launches, waves = serve_paged(
        torch, patterned, vae, specs, "kernel policy+int8 patterned", paged_decode_impl="kernel",
        decode_sparsity="policy", kv_dtype="int8")
    check_paged_run(engine, toks3, launches, waves, "kernel policy+int8 patterned",
                    "block_sparse_paged_flash_decode_int8", "block_sparse_flash_decode_int8",
                    patterned_tokens)
    if not engine.stats.kv_tiles_skipped > 0:
        fail(f"the patterned paged run skipped no tiles: {engine.sparsity_detail()}")
    out["block_sparse_paged_flash_decode"] = launches["block_sparse_paged_flash_decode_int8"]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from dalle_pytorch_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from dalle_pytorch_tpu_torch.models.dalle import DALLE, init_decode_cache
    from dalle_pytorch_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    model_name, peaks = card_peaks(kind)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"peaks ({model_name}): {json.dumps(peaks)}")

    # 1. build ---------------------------------------------------------
    t_start = t0 = time.perf_counter()
    kernels.build(["flash_decode", "flash_attention"])
    print(f"build: {time.perf_counter() - t0:.2f} s total")
    for name, info in kernels.build_log.items():
        print(f"build {name}: {info['seconds']:.2f} s -> {info['path']}")
        entry = ""
        for line in info["ptxas"].splitlines():
            compiling = re.search(r"Compiling entry function '([^']+)'", line)
            if compiling:  # a mangled name: show the kernel and its first int parameter
                m = re.search(r"\d([a-z][a-z_]*_kernel)(ILi(\d+)E)?", compiling.group(1))
                entry = (m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")) if m else ""
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {entry}: {line.strip()}")

    # 2. kernel vs plain ---------------------------------------------------
    cases = {
        "prefill": (MAIN["prefill"], [257, 257, 257, 257]),
        "prefill_edges": (MAIN["prefill"], [257, 320, 1024, 1281]),
        "step": (1, [258, 700, 1024, 1281]),
        "step_edges": (1, [1, 64, 65, 1280]),
    }
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, (n, lengths) in cases.items():
            q, k, v, lens = flash_inputs(torch, n, lengths, dtype)[0]
            out = flash_decode_attention(q, k, v, lens)
            ref = flash_decode_attention_plain(q, k, v, lens)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # bf16: one rounding step of the largest output (both round an
            # fp32 result once); fp32: summation order only
            scale = max(1.0, ref.float().abs().max().item())
            tol = 2.0**-7 * scale if dtype == torch.bfloat16 else 2e-5 * scale
            print(
                f"check flash_decode {case} {str(dtype)[6:]} n={n} lengths={lengths}: "
                f"max_abs_err {err:.3e} tol {tol:.3e}"
            )
            if not (err <= tol and torch.isfinite(out).all()):
                fail(f"flash_decode {case} {dtype} disagrees with its plain version")
            errs[(case, dtype)] = err
    # the other head dims, at small ragged shapes: a 5-row chunk (one block
    # over the cache) and a step over 700 positions (split-K, three spans)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for d in DECODE_OTHER_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for n, s_len, lengths in ((5, 100, [5, 37, 64, 100]), (1, 700, [1, 255, 256, 700])):
                q, k, v = (
                    torch.randn(shape, generator=g, device="cuda").to(dtype)
                    for shape in ((4, 2, n, d), (4, 2, s_len, d), (4, 2, s_len, d))
                )
                lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
                ref = flash_decode_attention_plain(q, k, v, lens).float()
                out = flash_decode_attention(q, k, v, lens).float()
                err = (out - ref).abs().max().item()
                scale = max(1.0, ref.abs().max().item())
                tol = 2.0**-7 * scale if dtype == torch.bfloat16 else 2e-5 * scale
                print(
                    f"check flash_decode D={d} {str(dtype)[6:]} n={n} S={s_len}: "
                    f"max_abs_err {err:.3e} tol {tol:.3e}"
                )
                if not (err <= tol and torch.isfinite(out).all()):
                    fail(f"flash_decode D={d} n={n} {dtype} disagrees with its plain version")

    check_head_dim_limit(torch)
    t0 = time.perf_counter()
    variant_errs = check_decode_variants(torch, cases)
    print(f"phase 2 int8 and block-sparse checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paged_errs, _ = check_paged_variants(torch)
    print(f"phase 2 paged checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attn_errs = check_attention(torch)
    print(f"phase 2 flash_attention checks: {time.perf_counter() - t0:.1f} s")

    # 3. times ---------------------------------------------------------------
    def library(q, k, v, lens):
        n, s = q.shape[2], k.shape[2]
        bound = lens.long()[:, None] - n + torch.arange(n, device="cuda")[None, :]
        mask = torch.arange(s, device="cuda")[None, None, :] <= bound[:, :, None]
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None])

    timings = {}
    for dtype, key, elt in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4)):
        for case in ("prefill", "step"):
            n, lengths = cases[case]
            inputs = flash_inputs(torch, n, lengths, dtype, copies=LAYERS)
            iters = 10 * LAYERS if case == "prefill" else 40 * LAYERS
            lib_err = (
                library(*inputs[0]).float() - flash_decode_attention_plain(*inputs[0]).float()
            ).abs().max().item()
            row = dict(
                ms=time_ms(torch, flash_decode_attention, inputs, iters),
                plain_ms=time_ms(torch, flash_decode_attention_plain, inputs, iters),
                library_ms=time_ms(torch, library, inputs, iters),
            )
            row["bound_ms"], row["bound_by"] = flash_bound(n, lengths, elt, peaks, key)
            timings[(case, key)] = row
            if key == "bf16":
                defer_device_time(row, flash_decode_attention, inputs, iters)
            print("time " + json.dumps(dict(
                kernel="flash_decode", case=case, dtype=key, n=n, lengths=lengths,
                library_max_abs_err=lib_err, **row,
            )))
            del inputs
    step = timings[("step", "bf16")]
    est = LAYERS * (timings[("prefill", "bf16")]["ms"] + 1024 * step["ms"])
    print(f"flash_decode per main-path batch (bf16, from the timed shapes): ~{est:.1f} ms")
    variant_times = time_decode_variants(torch, F, peaks, smi, cases)
    paged_times = time_paged_variants(torch, F, peaks, smi, cases)
    attn_times = time_attention(torch, F, peaks, torch.bfloat16, "bf16", 2)
    time_attention(torch, F, peaks, torch.float32, "fp32", 4)
    # the largest head dim the kernels take (the 256 instances: bf16 backward
    # in two column halves, fp32 dq / dk-dv with K and V sharing a buffer)
    attn_d256 = {key: time_attention(torch, F, peaks, dt, key, elt, d=256)
                 for dt, key, elt in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4))}

    # 4. model on the card: kernel path vs dense path ----------------------
    small = dict(
        dim=128, depth=2, heads=2, dim_head=64, num_image_tokens=64, image_fmap_size=8,
        num_text_tokens=100, text_seq_len=16, shift_tokens=True, rotary_emb=True,
    )
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        flash_model = DALLE(**small, attn_impl="flash").eval()
        dense_model = DALLE(**small, attn_impl="dense").eval()
    dense_model.load_state_dict(flash_model.state_dict())
    g = torch.Generator(device="cuda").manual_seed(SEED)
    text = torch.randint(
        1, small["num_text_tokens"], (2, small["text_seq_len"]), generator=g, device="cuda"
    )
    img = torch.randint(0, small["num_image_tokens"], (2, 64), generator=g, device="cuda")
    with torch.inference_mode():
        caches = [init_decode_cache(m, 2) for m in (flash_model, dense_model)]
        rows = [m.decode_prefill(text, c)[0] for m, c in zip((flash_model, dense_model), caches)]
        worst = (rows[0] - rows[1]).abs().max().item()
        for i in range(img.shape[1]):
            rows = [
                m.decode_image_step(img[:, i], i, c)[0]
                for m, c in zip((flash_model, dense_model), caches)
            ]
            worst = max(worst, (rows[0] - rows[1]).abs().max().item())
    print(
        "check model fp32 kernel-vs-dense logits over prefill + 64 steps: "
        f"max_abs_err {worst:.3e} tol 1e-4"
    )
    if not worst <= 1e-4:
        fail("the small model's kernel path disagrees with its dense path")
    check_small_model_training(torch)

    # 5. generation path -------------------------------------------------------
    engine, specs, n_params = flagship_engine()
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    toks, pixels = engine.generate(specs)
    wall = time.perf_counter() - t0
    launches = {"flash_decode": flash_decode_attention.launches}
    expected = LAYERS * (1 + engine.image_seq_len)
    print(
        f"main path: {n_params / 1e6:.1f} M DALLE params bf16, warmup {warm_s:.2f} s, "
        f"generate {wall:.3f} s for 4 images = {4 / wall:.3f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}"
    )
    if launches["flash_decode"] != expected:
        fail(f"flash_decode launched {launches['flash_decode']} times, expected {expected}")
    if toks.shape != (4, 1024) or toks.min() < 0 or toks.max() >= 8192:
        fail(f"tokens out of range or shape {toks.shape}")
    if pixels.shape != (4, 256, 256, 3) or not math.isfinite(float(pixels.sum())):
        fail(f"pixels not finite or shape {pixels.shape}")
    if len({tuple(t[:64]) for t in toks}) < 2:
        fail("all four prompts sampled the same tokens")

    # 6. training path, then its checkpoint served -------------------------------
    vae, model5 = engine.vae, engine.model
    del engine
    train_launches, _ = run_training(torch, vae, specs)
    launches.update(train_launches)

    # 7. continuous-serving path ---------------------------------------------------
    t0 = time.perf_counter()
    continuous_launches, causal_toks, patterned, patterned_toks = run_continuous(
        torch, model5, vae, specs, toks)
    launches.update(continuous_launches)
    print(f"phase 7 continuous serving: {time.perf_counter() - t0:.1f} s")

    # 8. paged continuous serving with a prefix cache ---------------------------------
    t0 = time.perf_counter()
    launches.update(run_paged(torch, model5, patterned, vae, specs, causal_toks, patterned_toks))
    print(f"phase 8 paged serving: {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s after the build started")

    # device time per call of phase 3's kernel rows, and the kernel the
    # forward's row ran, from traces made after every timed phase: a
    # torch.profiler trace leaves the CUDA tracer attached, which slows
    # each launch after it
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    for row, fn, inputs, iters in DEVICE_ROWS:
        row["device_ms"], row["device_kernels"] = device_ms(torch, fn, inputs, iters)
        print(f"device time {fn.__name__}: {row['device_ms']:.5f} ms a call (event time "
              f"{row['ms']:.5f}), kernels a call {json.dumps(row['device_kernels'])}")
    DEVICE_ROWS.clear()

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, h, n, d = TRAIN["batch"], TRAIN["heads"], TRAIN["n"], TRAIN["dim_head"]
    qkv = [torch.randn(b, h, n, d, generator=g, device="cuda").bfloat16() for _ in range(3)]
    traced = launched_kernel(torch, fa.flash_attention_fwd, qkv)
    attn_times["flash_attention_fwd"]["cuda_kernel"] = traced
    for name, row in attn_times.items():
        for key, rows in attn_d256.items():
            for field in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                if field in rows[name]:
                    row[f"d256_{key}_{field}"] = rows[name][field]
    print(f"phase 3's bf16 forward launches {traced} (torch.profiler trace of one call)")

    # result -------------------------------------------------------------------
    kernels_line = {
        "kernels": [
            dict(
                name="flash_decode",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:76",
                launches=launches["flash_decode"],
                max_abs_err=max(e for (c, d), e in errs.items() if d == torch.bfloat16),
                ms=step["ms"],
                plain_ms=step["plain_ms"],
                device_ms=step["device_ms"],
                device_kernels=step["device_kernels"],
                prefill_ms=timings[("prefill", "bf16")]["ms"],
                prefill_device_ms=timings[("prefill", "bf16")]["device_ms"],
                bound_ms=step["bound_ms"],
                bound_by=step["bound_by"],
                library_ms=step["library_ms"],
                timed="bf16 step n=1 B=4 H=16 D=64 S=1281 lengths [258, 700, 1024, 1281]",
            )
        ] + [
            dict(
                name=name,
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
                replaces=f"dalle_pytorch_tpu/ops/pallas_attention.py:{line}",
                launches=launches[name],
                max_abs_err=attn_errs[name],
                **attn_times[name],
                timed="bf16 causal B=4 H=16 N=1280 D=64"
                + ("" if name.endswith("fwd") else "; one fused kernel for dq, dk and dv; "
                   "library_ms is SDPA's whole backward, whole_backward_ms the port's (delta "
                   "+ workspace zeroing + kernel + dq conversion)"),
            )
            for name, line in (
                ("flash_attention_fwd", "129"),
                ("flash_attention_bwd", "274, dalle_pytorch_tpu/ops/pallas_attention.py:333"),
            )
        ] + [
            dict(
                name="flash_decode_int8",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:85",
                launches=launches["flash_decode_int8"],
                max_abs_err=variant_errs["flash_decode_int8"],
                **variant_times["flash_decode_int8"],
                timed="bf16 q, int8 K/V + fp32 scales, step n=1 B=4 H=16 D=64 S=1281 lengths "
                "[258, 700, 1024, 1281]; launches: phase 7 int8 run (depth 4); library_ms is "
                "SDPA over the bf16 cache",
            ),
            dict(
                name="block_sparse_flash_decode",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:292",
                launches=launches["block_sparse_flash_decode"]
                + launches["block_sparse_flash_decode_int8"],
                max_abs_err=variant_errs["block_sparse_flash_decode"],
                **variant_times["block_sparse_flash_decode"],
                timed="bf16 step n=1 B=4 H=16 D=64 S=1281, axial_row policy bitmap; launches: "
                "phase 7 policy run (bf16 arm, depth 4) + policy+int8 patterned run (int8 arm); "
                "library_ms is SDPA with the bitmap-expanded mask",
            ),
            dict(
                name="paged_flash_decode",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:446",
                launches=launches["paged_flash_decode"],
                max_abs_err=paged_errs["paged_flash_decode"],
                **paged_times["paged_flash_decode"],
                timed="bf16 step n=1 B=4 H=16 D=64, page 32, 41-entry tables into a shuffled "
                "206-page pool, lengths [258, 700, 1024, 1281]; launches: phase 8 kernel causal "
                "run; library_ms is SDPA over the cache gathered beforehand (gather not timed)",
            ),
            dict(
                name="block_sparse_paged_flash_decode",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:552",
                launches=launches["block_sparse_paged_flash_decode"],
                max_abs_err=paged_errs["block_sparse_paged_flash_decode"],
                **paged_times["block_sparse_paged_flash_decode"],
                timed="bf16 step as paged_flash_decode, axial_row policy bitmap re-expanded to "
                "pages; launches: phase 8 policy+int8 patterned run (int8 arm); library_ms is "
                "SDPA with the page-expanded mask over the gathered cache",
            ),
        ]
    }
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
