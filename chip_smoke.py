#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dalle_pytorch_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each failing loudly (nonzero exit, no result line):

1. the card's name and power limit (nvidia-smi), and the build of every
   kernel of the port from `dalle_pytorch_tpu_torch/csrc/` (one nvcc per
   source, started together: flash_decode.cu, flash_decode_tile.cu,
   flash_decode_tile_f32.cu, flash_attention.cu, and wide_head.cu and
   wide_decode_tile.cu, the head dims above 256), with ptxas's register
   and spill lines (no instance of either tile source may spill; no
   tensor-core instance of wide_head.cu or wide_decode_tile.cu may spill,
   and `cuobjdump -sass` must find HMMA in each; no split-K decode
   instance and no fp32 forward, multi-row decode or backward instance of
   wide_head.cu may spill, and each has its fixed count of instances; the
   fp32 kernels of flash_attention.cu, the forward `fwd_tf32_kernel` and
   the backward's TF32 passes `dq_tf32_kernel` and `dkv_tf32_kernel`, must
   have HMMA and no spill at each head dim);
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
   D = 264, 300, 320 and 1024 must route to the wide kernels (bf16
   attention to the tensor-core ones), which are held at D = 264-1024
   (decode: the five functions, both arms, NaN-poisoned caches, the bit
   identities at D = 320, the split-K step at n = 1 and 3 with a span
   left without a visible key, the tile kernel (bf16) and
   `wide_decode_fma_kernel` (fp32) at n = 5, 65 and 130 and the resume
   shape, each also against its model, the fp32 one bit-identical over
   two runs, and the split-K step at D = 1032 (its wide instance) and
   4104 (two column groups) with the bit identities; attention:
   the causal, all-keys and static-mask arms, forward and backward, and
   the causal arm at the training shapes at D = 320 and 512, the fp32
   forward's o and lse bit-identical over two runs; at D = 300, which the bf16
   kernels zero-pad, o and dv against the rounding-matched plain
   version per tile to 1e-3 plus one rounding flip of that tile); the fp32
   forward and backward at D <= 256 (their TF32 kernels) held to the exact
   plain version under ATTN_TOL["fp32"] (the forward in all three arms at
   D = 48, 64 and 256), o, lse, dq, dk and dv bit-identical over two runs,
   the forward also held to its split's model
   (`flash_attention_forward_tf32x3_plain`) and the backward's distance
   from its model (`flash_attention_bwd_tf32x3_plain`) printed;
3. times with CUDA events: each kernel, its plain version and one PyTorch
   library call computing the same function, beside the kernel's bound
   (the larger of bytes over memory bandwidth and flops over peak rate
   for the input type, this card's published peaks), flash attention
   also at D = 256; after phase 8 (a torch.profiler trace slows the
   launches after it) each bf16 kernel row's device time per call from a
   trace of the same timed calls (`device_ms`: CUDA events around
   back-to-back calls read the wrapper's host time once the kernel is
   shorter), and the CUDA kernel the bf16 forward's row ran
   (`cuda_kernel`: the wgmma kernel at D = 64); the wide kernels at D =
   320 and 512 in bf16 and fp32 (the step, the multi-row decode at the
   resume and prefill shapes, flash attention at the training shapes;
   SDPA's device time beside), their traces naming the kernels
   `attention_kernels` and `decode_arm` route to; the fp32 arms beside
   SDPA in fp32 (flash decode's fp32 tile arm at n = 257 and 1280, flash
   attention at D = 64 and 256, each with its own and SDPA's device time;
   the fp32 decode step with SDPA's device time); the step above the
   split-K kernel's narrow instance (D = 1032, its wide instance) in bf16
   and fp32 beside SDPA, each kernel named from its trace (the fp32
   forward's too); kernels 3-5 through the bf16 tile arm
   at the resume shape, at D = 64 and (the wide tile kernel) 320 and
   512, and kernels 2-5 through `wide_decode_fma_kernel` (fp32) at 320
   and 512, each beside SDPA with the same mask;
4. a small float32 model on the card, through the kernels against the
   same model through dense attention: its cached decode (the prefill
   and a resume launching the fp32 tile arm), and its training loss and
   every gradient; again at dim_head 320 (the wide kernels, their
   launches counted exactly: the steps on the split-K kernel, the prefill
   and resume on `wide_decode_fma_kernel`, the training run's forward and
   backward calls; at dim_head 64 the fp32 backward's calls, and after
   phase 10 a trace of one call naming its TF32 passes), there also the decode in bf16 (the
   prefill and resume on the tensor-core tile kernel) and the training
   step under bf16 autocast (the tensor-core wide kernels) against dense
   attention in bf16;
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
   `generate()` from it (train -> checkpoint -> serve; the model has the
   default vocabulary's text embedding, which its config implies);
   6b. the same DALLE trained in float32 (no autocast, `attn_impl="auto"`:
   the fp32 flash forward and the fp32 backward's TF32 passes): one warmup
   step, then FP32_TRAIN_STEPS Adam steps on one batch, ms a step by CUDA
   events, the flash-attention calls counted (12 a step each), the
   kernels named, the loss finite and falling;
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
   the gather impl on the model's first 4 layers (a depth cut that holds
   the script's time; tokens identical to phase 7's causal run of that
   model), the paged
   kernel with a pool of two rows' worst case beside the prefix cache
   (the batcher holds requests back; tokens identical again; one chunk
   under sync-debug "error"), and the block-sparse paged kernel's int8 arm
   under policy + int8 on phase 7's patterned model (tokens identical to
   phase 7's run of it); launches counted exactly, `leak_check()` empty;
9. the generation CLI (`python -m dalle_pytorch_tpu_torch.generate`, run
   in-process) on a flagship checkpoint of the default 32k vocabulary
   with a CLIP checkpoint at the reference defaults: two prompts of 4
   images with CLIP reranking (PNGs read back with zlib, 12,300
   flash-decode launches per batch, scores best first), one `--gentxt`
   run, and the uncached `generate_images` oracle primed with the cached
   run's first 1008 tokens (12 flash-attention forwards per sampled
   position, the cached tokens wherever the noised-score margin passes
   ORACLE_MARGIN); the wall of each stage;
10. mid-decode resume and decode-state migration: phase 5's model behind
   a `ContinuousEngine` with resume and previews, then a
   `PagedContinuousEngine` (page 32, the paged kernel), then int8 KV on
   phase 7's depth-4 model, each behind the `ContinuousBatcher` with
   phase 7's four requests (request 0 streamed; requests 2-3 admitted
   after ADMIT_AFTER chunks): at the first chunk boundary at which every
   row has passed image position DRAIN_AT (fixed chunk counts, not host
   timing), `migrate_out` exports them, the checkpoints
   travel encode -> wire -> decode, and a fresh engine over the same
   weights (equal fingerprint) resumes them in one dispatch (12
   flash-decode launches at n = 1280 at depth 12). Held: tokens equal to
   the uninterrupted run (phase 7's) up to each row's first position
   whose noised-score margin is under ORACLE_MARGIN, the resumed pending
   logits and K/V against the drained engine's (RESUME_LOGIT_TOL,
   RESUME_KV_TOL), every launch counted exactly, the decoded-token
   counter at the positions past each k, the streams' events in order,
   `leak_check()` empty, a post-resume chunk under sync-debug "error",
   each resume dispatch launching the tile arm once a layer;
   the resume dispatch's wall and device time, the export and codec
   walls.

Phases 2 and 3 also hold and time flash decode's tile arms
(`flash_decode_tile.cu`: bf16 q at n > 4 rows, P carried as a bf16 pair;
`flash_decode_tile_f32.cu`: fp32 q at n > 4; both cache arms) at the
prefill chunk (n = 257) and the resume forward's shape (n = 1280 rows over
a 1281-slot cache; B = 1 and 4), against the plain version and each arm's
model, on caches poisoned with NaN past each row's length, beside SDPA's
causal forward (and, bf16, `flash_attention_fwd`) over the live keys, and
check that each such call launches its arm once (phase 5: 12 tile
launches a generate(), phase 10: 12 a depth-12 resume dispatch). They
also hold the int8 arm of flash decode, the
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
import threading
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
ATTENTION_ARM_DIMS = (48, 256)  # fp32 flash attention's all-keys and static-mask arms, small shapes
FLAGSHIP = dict(
    dim=1024, depth=LAYERS, heads=16, dim_head=64, num_image_tokens=8192,
    image_fmap_size=32, num_text_tokens=10000, text_seq_len=256,
    shift_tokens=True, rotary_emb=True, attn_types=("full",),
)
REPO = Path(__file__).resolve().parent
# published peaks (NVIDIA data sheets, dense): HBM bytes/s, bf16, fp32
# (non-tensor-core) and TF32 (tensor-core) flop/s
PEAKS = {
    "H100 SXM": dict(bytes=3.35e12, bf16=989e12, fp32=67e12, tf32=495e12),
    "H100 PCIe": dict(bytes=2.0e12, bf16=756e12, fp32=51e12, tf32=378e12),
    "H100 NVL": dict(bytes=3.9e12, bf16=835e12, fp32=60e12, tf32=417.5e12),
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
    # seen 6.1e-4. At a D the wide kernels zero-pad, each tile's limit is
    # this plus the size of one flip computed from that tile's own data
    # (`flip_allowance`)
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


def attention_closeness(torch, out, ref, tile_limit=None):
    """(max |err|, worst element ratio, worst tile ratio) of out against
    ref, both [B, H, N, D] or [B, H, N] (lse); tiles are 64 rows of N.
    With `tile_limit` ([B, H, tiles], each tile's own limit) the tile
    ratio is taken where ratio - limit is largest, and returned with its
    limit and with every tile's (ratio, limit) as a fourth and fifth
    value."""
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
    ratios = err.square().sum((-1, -2)).sqrt() / ref_sq.sqrt().clamp(min=1e-30)
    finite = bool(torch.isfinite(out).all())
    if tile_limit is None:
        tile = ratios.amax().item() if finite else math.inf
        return err.abs().max().item(), element if finite else math.inf, tile
    at = torch.argmax((ratios - tile_limit).flatten())
    tile, limit = ratios.flatten()[at].item(), tile_limit.flatten()[at].item()
    pairs = list(zip(ratios.flatten().tolist(), tile_limit.flatten().tolist()))
    return err.abs().max().item(), element if finite else math.inf, tile if finite else math.inf, limit, pairs


def bf16_ulp(torch, x):
    """One bf16 ulp of each positive x: 2^(floor(log2 x) - 7) (8 bits)."""
    return torch.exp2(torch.floor(torch.log2(x.clamp(min=1e-38))) - 7)


def flip_allowance(torch, q, k, v, do, lse, mask, causal, o_ref, dv_ref):
    """The size of one bf16 rounding flip of P in each 64-row tile of o and
    of dv, over that tile's reference norm, from the tile's own data ([B,
    H, tiles] each): one bf16 ulp of the tile's largest P (P = exp(s
    scale - lse), normalized, over the tile's query rows for o and its
    keys for dv) times the largest row norm of V (o) or of dO (dv) that
    multiplies it, over ||ref tile||."""
    import torch.nn.functional as F

    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    mode, fm = fa._resolve(None if mask is None else fa.flash_mask(mask, q.device), causal, q, k)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    visible = fa._visible(mode, fm, n_q, n_k, q.device)
    if visible is not None:
        s = s.masked_fill(~visible, float("-inf"))
    p = torch.exp(s - lse[..., None])

    def tiles_max(x, n):  # [B, H, n, ...] -> the max over each 64-row tile of dim 2
        x = F.pad(x.flatten(3).amax(-1), (0, (-n) % 64))
        return x.view(b, h, -1, 64).amax(-1)

    def ref_norm(r):
        n = r.shape[2]
        return F.pad(r.float().square().sum(-1), (0, (-n) % 64)).view(b, h, -1, 64).sum(-1).sqrt()

    v_rows = v.float().norm(dim=-1).amax(-1)[..., None]  # [B, H, 1]
    do_rows = do.float().norm(dim=-1).amax(-1)[..., None]
    o_flip = bf16_ulp(torch, tiles_max(p, n_q)) * v_rows / ref_norm(o_ref).clamp(min=1e-30)
    dv_flip = bf16_ulp(torch, tiles_max(p.transpose(-1, -2), n_k)) * do_rows / ref_norm(dv_ref).clamp(min=1e-30)
    return o_flip, dv_flip


def attention_bound(kind, elt, peaks, dtype_key, d=TRAIN["dim_head"]):
    """(bound_ms, bound_by) of one flash-attention pass at TRAIN's causal
    shapes (head dim `d`): each input read once and each output written
    once; 4*D (fwd: S, P.V) or 10*D (bwd: S, dP, dV, dK, dQ) flops per
    visible (query, key) pair at `dtype_key`'s peak; "tf32x3" (the fp32
    kernels at D <= 256: three TF32 products each) is three times those
    flops at the TF32 peak."""
    b, h, n = TRAIN["batch"], TRAIN["heads"], TRAIN["n"]
    rows, pairs = b * h * n, b * h * n * (n + 1) // 2
    nbytes, flops = {
        "fwd": (4 * rows * d * elt + 4 * rows, 4 * d * pairs),    # q,k,v,o + lse
        "bwd": (7 * rows * d * elt + 8 * rows, 10 * d * pairs),   # q,k,v,do,dq,dk,dv + lse,delta
    }[kind]
    rate = peaks["tf32"] / 3 if dtype_key == "tf32x3" else peaks[dtype_key]
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / rate
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
    """(ms, {kernel name: launches}) per call on the card, from a
    torch.profiler trace of `iters` calls (rotating through `inputs`, as
    time_ms): for each kernel or memset the calls launch, its mean device
    time times its launches per call (at least one), summed. The trace
    may drop some launches' records (it kept 20-57% of the D = 64
    flash-attention calls' on an H100), so the means, not the sums, are
    taken; `launches` reports what it kept; a trace that kept no record
    is taken again, up to three times. Traces slow the launches after
    them, so these run after every other timed phase."""
    from torch.profiler import ProfilerActivity, profile

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = {}
    for _ in range(3):  # after dozens of traces in one process the profiler can drop a whole trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for it in range(iters):
                fn(*inputs[it % len(inputs)])
            torch.cuda.synchronize()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
                found = re.search(r"\w+_kernel<[^<>]*>|\w+_kernel\b", evt.name)
                name = found.group(0) if found else evt.name[:60]
                times.setdefault(name, []).append(evt.time_range.elapsed_us())
        if times:
            break
    if not times:
        fail(f"{getattr(fn, '__name__', fn)}: three traces held no device activity")
    total_us = sum(
        sum(us) / len(us) * max(1, round(len(us) / iters)) for us in times.values()
    )
    return total_us / 1e3, {k: len(us) / iters for k, us in times.items()}


# rows of phase 3 whose device time is taken after phase 8: (row, fn,
# inputs, iters); device_ms fills row["device_ms"] and row["device_kernels"]
DEVICE_ROWS = []


def defer_device_time(row, fn, inputs, iters, prefix=""):
    """Take fn's device time into row[prefix + "device_ms"] (and
    "device_kernels") after the last timed phase."""
    DEVICE_ROWS.append((row, fn, inputs, iters, prefix))


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


# the flash-decode wrappers: each counts its launches at D <= 256, every arm
# (`launches`, `int8_launches`), and of those the tile arm's (`tile_launches`,
# `tile_int8_launches`)
DECODE_FUNCTIONS = ("flash_decode_attention", "block_sparse_flash_decode_attention",
                    "paged_flash_decode_attention", "block_sparse_paged_flash_decode_attention")


def tile_launches(arm="tile"):
    """Launches of the tile arm `arm` ("tile": bf16 q, "tile_f32": fp32 q)
    so far, over the four wrappers and both cache arms."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    return sum(getattr(getattr(fd, f), f"{arm}_launches") + getattr(getattr(fd, f), f"{arm}_int8_launches")
               for f in DECODE_FUNCTIONS)


def poison_past_length(torch, k, v, lens, sc=()):
    """The contiguous cache with NaN at every position past each row's
    length (in the scales of an int8 cache, whose values hold no NaN)."""
    dead = torch.arange(k.shape[2], device=k.device)[None, :] >= lens.long()[:, None]
    if sc:
        return k, v, tuple(t.masked_fill(dead[:, None], float("nan")) for t in sc)
    dead = dead[:, None, :, None]
    return k.masked_fill(dead, float("nan")), v.masked_fill(dead, float("nan")), ()


def check_tile_arm(torch, cases):
    """Phase 2 for the two tile arms (n > DECODE_ROWS): bf16 q on
    `csrc/flash_decode_tile.cu`, fp32 q on `csrc/flash_decode_tile_f32.cu`.
    Kernels 1 and 2 (int8) against the plain version and against the arm's
    model (`flash_decode_tile_plain`, P as the bf16 pair the kernel
    multiplies; `flash_decode_tile_f32_plain`), both under decode_tol in
    q's dtype, at the prefill shapes and the resume shape (B = 1 and 4),
    each call launching its arm once and the other arm never; the
    prefill_edges and resume-B=4 caches poisoned with NaN past each row's
    length giving finite outputs bit-identical to the clean ones. Returns
    {kernel: worst max_abs_err against the plain version}."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    worst = {}
    failures = []
    arms = ((torch.bfloat16, "tile", "flash_decode_tile", fd.flash_decode_tile_plain),
            (torch.float32, "tile_f32", "flash_decode_tile_f32", fd.flash_decode_tile_f32_plain))
    for dtype, arm, name, model_fn in arms:
        other = "tile_f32" if arm == "tile" else "tile"
        shapes = [(c, lambda c=c: flash_inputs(torch, *cases[c], dtype)[0])
                  for c in ("prefill", "prefill_edges")]
        shapes += [(f"resume B={b}", lambda b=b: resume_inputs(torch, b, dtype)[0]) for b in (1, 4)]
        for label, make in shapes:
            q, k, v, lens = make()
            kq, vq, ks, vs = quantized(torch, k, v)
            for kernel, kk, vv, sc in ((name, k, v, ()), (name + "_int8", kq, vq, (ks, vs))):
                before = (tile_launches(arm), tile_launches(other))
                out = fd.flash_decode_attention(q, kk, vv, lens, *sc)
                ran = (tile_launches(arm) - before[0], tile_launches(other) - before[1])
                ref = fd.flash_decode_attention_plain(q, kk, vv, lens, *sc)
                model = model_fn(q, kk, vv, lens, *sc)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                err_model = (out.float() - model.float()).abs().max().item()
                tol = decode_tol(torch, ref, dtype)
                print(f"check {kernel} {label} n={q.shape[2]} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                      f"vs plain, {err_model:.3e} vs the arm's model, tol {tol:.3e}; launches of "
                      f"this arm / the other {ran}")
                if not (err <= tol and err_model <= tol and torch.isfinite(out).all()) or ran != (1, 0):
                    failures.append(f"{kernel} {label}: {err:.3e} / {err_model:.3e} over {tol:.3e} "
                                    f"or launches {ran}")
                worst[kernel] = max(worst.get(kernel, 0.0), err)
                if label in ("prefill_edges", "resume B=4"):
                    pk, pv, psc = poison_past_length(torch, kk, vv, lens, sc)
                    poisoned = fd.flash_decode_attention(q, pk, pv, lens, *psc)
                    same = torch.equal(out, poisoned) and bool(torch.isfinite(poisoned).all())
                    print(f"check {kernel} {label}: NaN past each row's length, finite and unchanged {same}")
                    if not same:
                        failures.append(f"{kernel} {label}: NaN past the lengths changed the output")
                    del pk, pv, psc, poisoned
                del out, ref, model
            del q, k, v, kq, vq, ks, vs
    if failures:
        fail("tile arms: " + "; ".join(failures))
    return worst


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


def mangled_kernel(name: str) -> str:
    """A kernel's mangled name as a trace names it, "kernel<192, true>"
    (its int and bool template arguments; "kernel" where they are types).
    The kernel's identifier is the `<length><name>` whose name ends in
    "_kernel"; the length is found among the suffixes of each digit run,
    since a namespace's hash digits may run into it."""
    for run in re.finditer(r"\d+", name):
        for start in range(run.start(), run.end()):
            ident = name[run.end():run.end() + int(name[start:run.end()])]
            if re.fullmatch(r"[a-z]\w*_kernel", ident):
                m = re.match(r"I((?:L[a-z]\d+E)+)E", name[run.end() + len(ident):])
                args = [("true" if v == "1" else "false") if t == "b" else v
                        for t, v in re.findall(r"L([a-z])(\d+)E", m.group(1) if m else "")]
                return ident + (f"<{', '.join(args)}>" if args else "")
    return name[:60]


def built_kernels(info, name=mangled_kernel):
    """{kernel: {"registers", "spill_bytes", "hmma"}} of one built source:
    registers and spills from ptxas's lines in `info` (a
    `kernels.build_log` entry), the tensor-core instructions (HMMA) from
    `cuobjdump -sass` of the built library; kernels keyed by `name` of
    their mangled names."""
    from dalle_pytorch_tpu_torch import kernels

    out, entry = {}, None
    for line in info["ptxas"].splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = name(found.group(1))
            out.setdefault(entry, {})
            continue
        regs = re.search(r"Used (\d+) registers", line)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if entry and regs:
            out[entry]["registers"] = int(regs.group(1))
        if entry and spills:
            out[entry]["spill_bytes"] = int(spills.group(1)) + int(spills.group(2))
    cuobjdump = Path(kernels.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", info["path"]], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        out.setdefault(name(block.split(None, 1)[0]), {})["hmma"] = len(re.findall(r"\bHMMA\.", block))
    if not info["ptxas"]:  # loaded from an earlier build: ptxas did not run here
        print(f"note: {info['path']} was loaded from disk, so its ptxas lines (spills) are not checked")
    return out


def tensor_core_faults(info, found):
    """The kernels of `found` (from built_kernels) that spill or have no HMMA."""
    return {k: v for k, v in found.items() if v.get("spill_bytes", 0) or not v.get("hmma")
            or (info["ptxas"] and "spill_bytes" not in v)}


def instance_builds(info, kernel):
    """[(registers, spill bytes)] of each instance of `kernel`, a kernel
    whose template arguments are types (its instances share one name in
    `built_kernels`), from ptxas's lines in `info`."""
    found, raw, spill = [], "", None
    for line in info["ptxas"].splitlines():  # an entry's spill line comes before its registers
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        raw, spill = (entry.group(1), None) if entry else (raw, spill)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and kernel in raw:
            spill = (spill or 0) + int(spills.group(1)) + int(spills.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel in raw:
            found.append([int(used.group(1)), spill])
    return found


def check_wide_build(info):
    """Phase 1 for `csrc/wide_head.cu` (`built_kernels`). Fails if a
    tensor-core kernel (`*_mma_kernel`) spills or has no HMMA, or if an
    fp32 kernel (the forward `wide_fwd_fma_kernel`, the backward's passes,
    the multi-row decode `wide_decode_fma_kernel`) or a split-K decode
    kernel (`wide_split_kernel`) spills, or if any of them has not its
    fixed count of instances. Returns {kernel: {...}}."""
    out = built_kernels(info)
    mma = {k: v for k, v in out.items() if "_mma_kernel" in k}
    if len(mma) != 6 or tensor_core_faults(info, mma):  # forward 2 column counts, backward 1, each resident and streaming
        fail(f"wide_head's tensor-core kernels: expected 6 instances with HMMA and no spill, got {mma}")
    for prefixes, count, what in ((("wide_dq_fma", "wide_dkv_fma"), 6, "fp32 backward passes"),
                                  (("wide_fwd_fma",), 3, "fp32 forward")):  # x 192, 256, 320 columns
        fma = {k: v for k, v in out.items() if k.startswith(prefixes)}
        if len(fma) != count or any(v.get("spill_bytes", 0) or (info["ptxas"] and "spill_bytes" not in v)
                                    for v in fma.values()):
            fail(f"wide_head's {what}: expected {count} instances without spills, got {fma}")
    # the kernels with type template arguments (one name): each instance's spills
    for kernel, count in (("wide_split_kernel", 24),  # q fp32/bf16 x cache own/int8 x rows 1/4 x (2, 8, 8 in pieces)
                          ("wide_decode_fma_kernel", 6)):  # cache fp32/int8 x 192, 256, 320 columns
        builds = instance_builds(info, kernel)
        out.setdefault(kernel, {})["instance_registers_spill_bytes"] = builds
        if any(spill != 0 for _, spill in builds) or (info["ptxas"] and len(builds) != count):
            fail(f"wide_head's {kernel}: expected {count} instances without spills, got {builds}")
    return out


def check_tf32_build(info):
    """Phase 1 for the fp32 kernels of `csrc/flash_attention.cu`
    (`built_kernels`): fails unless the forward `fwd_tf32_kernel` and the
    backward's two passes `dq_tf32_kernel` and `dkv_tf32_kernel` have one
    instance at each of the kernels' head dims (16, 32, 64, 128, 256), each
    with HMMA (the TF32 mma.sync) and without a spill. Returns {kernel:
    {...}}."""
    out = {k: v for k, v in built_kernels(info).items()
           if k.startswith(("fwd_tf32_kernel", "dq_tf32_kernel", "dkv_tf32_kernel"))}
    if len(out) != 15 or tensor_core_faults(info, out):
        fail(f"flash_attention's fp32 kernels: expected 15 TF32 instances with HMMA and no spill, got {out}")
    return out


def check_wide_tile_build(info):
    """Phase 1 for `csrc/wide_decode_tile.cu` (`built_kernels`, each
    instance by its mangled name). Fails unless there are 4 instances
    (bf16 / int8 cache x Q resident / streamed), each with HMMA and
    without a spill."""
    out = built_kernels(info, name=lambda mangled: mangled)
    if len(out) != 4 or tensor_core_faults(info, out):
        fail(f"wide_decode_tile: expected 4 instances with HMMA and no spill, got {out}")
    return out


def check_head_dim_limit(torch):
    """Phase 2: head dims above 256 run on the card, none raises: the
    decode and flash-attention wrappers route D = 264, 300, 320 and 1024 to
    the wide kernels (`ops/wide_head.py`), each call launching there once, the
    bf16 flash attention on the tensor-core kernels."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd
    from dalle_pytorch_tpu_torch.ops import wide_head as wh

    counters = (wh.wide_decode, wh.wide_attention_fwd, wh.wide_attention_bwd)
    mma = (wh.wide_attention_fwd, wh.wide_attention_bwd)
    for d in (264, 300, 320, 1024):  # 300: bf16 pads it to 304
        q = torch.randn((1, 1, 2, d), dtype=torch.bfloat16, device="cuda")
        lens = torch.full((1,), 2, dtype=torch.int32, device="cuda")
        before = [c.launches for c in counters] + [c.mma_launches for c in mma]
        fd.flash_decode_attention(q, q, q, lens)
        o, lse = fa.flash_attention_fwd(q, q, q)
        fa.flash_attention_bwd(q, q, q, q, lse, lse)
        torch.cuda.synchronize()
        ran = [c - b for c, b in zip([c.launches for c in counters] + [c.mma_launches for c in mma], before)]
        print(f"check D={d} routes to the wide kernels: launches decode / forward / backward, "
              f"tensor-core forward / backward {ran}; {json.dumps(fa.attention_kernels(d, torch.bfloat16))}")
        if ran != [1, 1, 1, 1, 1]:
            fail(f"D = {d} did not launch each wide kernel once: {ran}")


# head dims above 256: every decode variant at these D, the bit identities
# at WIDE_IDENTITY_DIM, flash attention at WIDE_ATTENTION_DIMS (300: bf16
# zero-pads it to 304), times, and flash attention at TRAIN's shapes, at
# WIDE_TIMED_DIMS
WIDE_DECODE_DIMS = (264, 320, 512, 1024)
WIDE_ATTENTION_DIMS = (264, 300, 320, 512, 1024)
# fp32 flash attention at D that are no multiple of 4: the fp32 backward's
# 8-byte (330) and 4-byte (331) copy pieces
WIDE_ODD_DIMS = (330, 331)
WIDE_IDENTITY_DIM = 320
WIDE_TIMED_DIMS = (320, 512)
# the step above the split-K kernel's narrow instance (1024 channels): its
# wide instance, one column group; and above the wide instance's 4096
# columns: two column groups, K staged in 4096-channel pieces
WIDE_STEP_DIM = 1032
WIDE_GROUP_DIM = 4104


WIDE_DECODE_CASES = (  # (n, lengths) over a 300-position cache
    (1, [1, 130, 257, 300]), (3, [3, 129, 256, 300]), (5, [5, 64, 200, 300]),
    (65, [65, 100, 200, 300]), (130, [130, 131, 257, 300]),
)


def check_wide_decode(torch):
    """Phase 2 for the wide decode kernels (D > 256): kernels 1-5 (the
    contiguous cache, block-sparse over 32-position blocks, paged with
    16-position pages through a shuffled table, block-sparse paged), each
    arm (the cache in q's dtype, int8) against its plain version under
    decode_tol, at a one-row step and a 3-row chunk (the split-K kernel,
    row 3's second span dead in the bitmaps; also at WIDE_STEP_DIM, its
    wide instance, and WIDE_GROUP_DIM, its column groups), and at 5, 65 and
    130 rows (the query tiles' edges) on the
    tile kernel (bf16) or `wide_decode_fma_kernel` (fp32), each launching
    there and held also against its model (`flash_decode_tile_plain`,
    `flash_decode_tile_f32_plain`) under decode_tol; every kernel's output
    unchanged and finite with NaN in every position no row may read (in
    the scales of an int8 cache); at WIDE_IDENTITY_DIM (and the split-K
    steps at WIDE_STEP_DIM and WIDE_GROUP_DIM) bit for bit: the
    all-ones bitmap against kernels 1 and 4, kernel 4 against kernel 1 and
    kernel 5 against kernel 3 on the gathered view, and (fp32 multi-row)
    kernel 5's output over two runs; and both multi-row kernels at the
    resume shape at WIDE_IDENTITY_DIM (`check_wide_tile_resume`). Returns
    ({arm: worst max_abs_err against the plain version}, {check: cases
    held or launches})."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd
    from dalle_pytorch_tpu_torch.ops import wide_head as wh

    worst, failures = {}, []
    held = {"all-ones bitmap vs kernel 1": 0, "all-ones page bitmap vs kernel 4": 0,
            "kernel 4 vs kernel 1 on the gathered view": 0,
            "kernel 5 vs kernel 3 on the gathered view": 0, "poisoned cache unchanged": 0,
            "the same bits over two runs": 0}

    def same(name, label, a, b):
        if torch.equal(a, b) and bool(torch.isfinite(a).all()):
            held[name] += 1
        else:
            failures.append(f"{label}: {name} failed (max_abs_err "
                            f"{(a.float() - b.float()).abs().max().item():.1e})")

    def nan_where(kk, vv, sc, dead):
        """The cache with NaN where `dead` [B or P, S or page] (in the
        scales of an int8 cache, whose values hold no NaN)."""
        if sc:
            return kk, vv, tuple(t.masked_fill(dead[:, None], float("nan")) for t in sc)
        dead = dead[:, None, :, None]
        return kk.masked_fill(dead, float("nan")), vv.masked_fill(dead, float("nan")), ()

    page, block, b, h, s_len = 16, 32, 4, 2, 300
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    wd = wh.wide_decode
    before = (wd.launches, wd.split_launches, wd.tile_launches, wd.tile_f32_launches)
    models = {"wide_tile": fd.flash_decode_tile_plain, "wide_tile_f32": fd.flash_decode_tile_f32_plain}
    for d in WIDE_DECODE_DIMS + (WIDE_STEP_DIM, WIDE_GROUP_DIM):
        step_only = d in (WIDE_STEP_DIM, WIDE_GROUP_DIM)
        for dtype in (torch.bfloat16, torch.float32):
            for n, lengths in WIDE_DECODE_CASES:
                if step_only and n > 4:
                    continue
                t_case = time.perf_counter()
                arm = fd.decode_arm(n, dtype, d)
                q, k, v, lens, table, live = paged_case(
                    torch, b, h, n, d, page, lengths, dtype, s_len, SEED + d + n)
                n_pages = table.shape[1]
                bm = (torch.rand((b, -(-s_len // block)), generator=g, device="cuda") < 0.5).to(torch.int32)
                bm[:, 0] = 1
                bm[3, 4:8] = 0  # row 3's second span (keys 128-255) has no visible key
                pbm = (torch.rand((b, n_pages), generator=g, device="cuda") < 0.5).to(torch.int32)
                pbm[:, :2] = 1  # the shared pages stay live
                pbm[3, 8:16] = 0
                sparse_live = paged_live(torch, table, lengths, page, k.shape[0], pbm.tolist())
                in_len = torch.arange(s_len, device="cuda")[None, :] < lens[:, None]
                kq, vq, ks, vs = quantized(torch, k, v)
                errs, model_errs = [], []
                for cache_arm, kk, vv, sc in (("", k, v, ()), (" int8", kq, vq, (ks, vs))):
                    label = f"D={d} n={n} {str(dtype)[6:]}{cache_arm}"
                    kc, vc = fd.paged_gather(kk, table, s_len), fd.paged_gather(vv, table, s_len)
                    scc = tuple(fd.paged_gather(t, table, s_len) for t in sc)
                    launched = (wd.tile_launches, wd.tile_f32_launches)
                    outs = {
                        "flash_decode": (fd.flash_decode_attention(q, kc, vc, lens, *scc),
                                         fd.flash_decode_attention_plain(q, kc, vc, lens, *scc)),
                        "block_sparse": (
                            fd.block_sparse_flash_decode_attention(q, kc, vc, lens, bm, block, *scc),
                            fd.block_sparse_flash_decode_attention_plain(q, kc, vc, lens, bm, block, *scc)),
                        "paged": (fd.paged_flash_decode_attention(q, kk, vv, lens, table, *sc),
                                  fd.paged_flash_decode_attention_plain(q, kk, vv, lens, table, *sc)),
                        "block_sparse_paged": (
                            fd.block_sparse_paged_flash_decode_attention(q, kk, vv, lens, table, pbm, *sc),
                            fd.block_sparse_paged_flash_decode_attention_plain(
                                q, kk, vv, lens, table, pbm, *sc)),
                    }
                    ran = (wd.tile_launches - launched[0], wd.tile_f32_launches - launched[1])
                    if ran != (4 * (arm == "wide_tile"), 4 * (arm == "wide_tile_f32")):
                        failures.append(f"{label}: {ran} (tile, fp32 multi-row) launches for 4 calls of "
                                        f"the {arm} arm")
                    arm_models = {}
                    if arm in models:  # the kernel's arithmetic, each variant
                        model = models[arm]
                        arm_models = {
                            "flash_decode": model(q, kc, vc, lens, *scc),
                            "block_sparse": model(q, kc, vc, lens, *scc, block_bitmap=bm, block_k=block),
                            "paged": model(q, kk, vv, lens, *sc, page_table=table),
                            "block_sparse_paged": model(q, kk, vv, lens, *sc, block_bitmap=pbm,
                                                        page_table=table),
                        }
                    for kernel, (out, ref) in outs.items():
                        err = (out.float() - ref.float()).abs().max().item()
                        tol = decode_tol(torch, ref, dtype)
                        errs.append(err)
                        if not (err <= tol and torch.isfinite(out).all()):
                            failures.append(f"{kernel} {label}: {err:.3e} over {tol:.3e}")
                        if kernel in arm_models:
                            err_model = (out.float() - arm_models[kernel].float()).abs().max().item()
                            model_errs.append(err_model)
                            if not err_model <= tol:
                                failures.append(f"{kernel} {label}: {err_model:.3e} over {tol:.3e} "
                                                f"against the {arm} model")
                        worst[arm] = max(worst.get(arm, 0.0), err)
                    # NaN wherever no row may read: kernels 1 and 3 on the
                    # contiguous cache, kernels 4 and 5 in the pool
                    pk, pv, psc = nan_where(kc, vc, scc, ~in_len)
                    same("poisoned cache unchanged", label + " kernel 1",
                         fd.flash_decode_attention(q, pk, pv, lens, *psc), outs["flash_decode"][0])
                    dead = ~(in_len & fd.expand_bitmap(bm, block, s_len))
                    pk, pv, psc = nan_where(kc, vc, scc, dead)
                    same("poisoned cache unchanged", label + " kernel 3",
                         fd.block_sparse_flash_decode_attention(q, pk, pv, lens, bm, block, *psc),
                         outs["block_sparse"][0])
                    pk, pv, psc = nan_where(kk, vv, sc, ~live)
                    same("poisoned cache unchanged", label + " kernel 4",
                         fd.paged_flash_decode_attention(q, pk, pv, lens, table, *psc), outs["paged"][0])
                    pk, pv, psc = nan_where(kk, vv, sc, ~sparse_live)
                    same("poisoned cache unchanged", label + " kernel 5",
                         fd.block_sparse_paged_flash_decode_attention(q, pk, pv, lens, table, pbm, *psc),
                         outs["block_sparse_paged"][0])
                    if d == WIDE_IDENTITY_DIM or step_only:
                        ones, pones = torch.ones_like(bm), torch.ones_like(pbm)
                        same("all-ones bitmap vs kernel 1", label,
                             fd.block_sparse_flash_decode_attention(q, kc, vc, lens, ones, block, *scc),
                             outs["flash_decode"][0])
                        same("all-ones page bitmap vs kernel 4", label,
                             fd.block_sparse_paged_flash_decode_attention(q, kk, vv, lens, table, pones, *sc),
                             outs["paged"][0])
                        same("kernel 4 vs kernel 1 on the gathered view", label,
                             outs["paged"][0], outs["flash_decode"][0])
                        same("kernel 5 vs kernel 3 on the gathered view", label,
                             outs["block_sparse_paged"][0],
                             fd.block_sparse_flash_decode_attention(q, kc, vc, lens, pbm, page, *scc))
                        if arm == "wide_tile_f32":
                            same("the same bits over two runs", label + " kernel 5",
                                 fd.block_sparse_paged_flash_decode_attention(q, kk, vv, lens, table, pbm, *sc),
                                 outs["block_sparse_paged"][0])
                print(f"check wide decode ({arm}) D={d} n={n} {str(dtype)[6:]} lengths={lengths}: max_abs_err "
                      "kernels 1, 3, 4, 5 then their int8 arms: " + ", ".join(f"{e:.2e}" for e in errs)
                      + (f"; against the {arm} model: " + ", ".join(f"{e:.2e}" for e in model_errs)
                         if model_errs else "")
                      + (f" ({time.perf_counter() - t_case:.1f} s)" if step_only else ""))
    for dtype, arm in ((torch.bfloat16, "wide_tile"), (torch.float32, "wide_tile_f32")):
        worst[arm] = max(worst.get(arm, 0.0), check_wide_tile_resume(torch, failures, dtype))
    torch.cuda.synchronize()
    split = wd.split_launches - before[1]
    tile = wd.tile_launches - before[2]
    tile_f32 = wd.tile_f32_launches - before[3]
    held["split-K kernel launches"] = split
    held["tile kernel launches"] = tile
    held["fp32 multi-row kernel launches"] = tile_f32
    print("check wide decode bit identities and poisoned caches (cases held): " + json.dumps(held))
    if wd.launches - before[0] != split + tile + tile_f32:
        failures.append(f"{wd.launches - before[0]} wide decode launches, {split + tile + tile_f32} counted by arm")
    if not (split and tile and tile_f32):
        failures.append("the split-K, the tile or the fp32 multi-row kernel never launched")
    if failures:
        fail("wide decode: " + "; ".join(failures[:10]))
    return worst, held


def check_wide_tile_resume(torch, failures, dtype=None):
    """Phase 2 for a multi-row wide decode kernel at the resume shape (B =
    4, H = 16, n = 1280, S = 1281, lengths 1280) at WIDE_IDENTITY_DIM, q in
    `dtype` (bf16: the tile kernel, fp32: `wide_decode_fma_kernel`), both
    cache arms: against the plain version and the kernel's model under
    decode_tol, with NaN past each row's length unchanged. Appends to
    `failures`; returns the worst max_abs_err against the plain version."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    dtype = dtype or torch.bfloat16
    q, k, v, lens = resume_inputs(torch, MAIN["batch"], dtype, d=WIDE_IDENTITY_DIM)[0]
    arm = fd.decode_arm(q.shape[2], dtype, WIDE_IDENTITY_DIM)
    model_of = fd.flash_decode_tile_plain if dtype == torch.bfloat16 else fd.flash_decode_tile_f32_plain
    kq, vq, ks, vs = quantized(torch, k, v)
    worst = 0.0
    for cache_arm, kk, vv, sc in (("", k, v, ()), (" int8", kq, vq, (ks, vs))):
        out = fd.flash_decode_attention(q, kk, vv, lens, *sc)
        ref = fd.flash_decode_attention_plain(q, kk, vv, lens, *sc)
        model = model_of(q, kk, vv, lens, *sc)
        pk, pv, psc = poison_past_length(torch, kk, vv, lens, sc)
        poisoned = fd.flash_decode_attention(q, pk, pv, lens, *psc)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err_model = (out.float() - model.float()).abs().max().item()
        tol = decode_tol(torch, ref, dtype)
        unchanged = torch.equal(out, poisoned) and bool(torch.isfinite(out).all())
        print(f"check wide decode ({arm}) resume D={WIDE_IDENTITY_DIM}{cache_arm} n={q.shape[2]} "
              f"B={q.shape[0]}: max_abs_err {err:.3e} vs plain, {err_model:.3e} vs the model, tol "
              f"{tol:.3e}; NaN past the lengths finite and unchanged {unchanged}")
        if not (err <= tol and err_model <= tol and unchanged):
            failures.append(f"{arm} resume{cache_arm}: {err:.3e} / {err_model:.3e} over {tol:.3e} "
                            f"or poisoned output changed")
        worst = max(worst, err)
        del out, ref, model, pk, pv, psc, poisoned
    return worst


def check_wide_attention(torch):
    """Phase 2 for the wide flash-attention forward and backward (D > 256):
    the causal, all-keys and static-mask (causal axial_row) arms at
    WIDE_ATTENTION_DIMS, bf16 and fp32, and in fp32 also at
    WIDE_ODD_DIMS (no multiple of 4: the fp32 backward's narrow copies); the
    causal arm at TRAIN's shapes (20 query and key tiles) at
    WIDE_TIMED_DIMS, bf16 and fp32, through `attention_case` (ATTN_TOL, dk
    and dv bit-identical over two runs, fp32 dq too). At a
    D the kernels zero-pad (300) the bf16 o and dv against the
    rounding-matched plain version are held per tile to ATTN_TOL's limit
    plus one bf16 rounding flip of that tile's largest P
    (`flip_allowance`): one flipped rounding of a P that few rows see
    exceeds 1e-3 alone there. Returns {"bf16" | "fp32": {kernel: worst
    max_abs_err}}."""
    import numpy as np

    from dalle_pytorch_tpu_torch.models.transformer import build_static_mask

    n = 160  # 97 text + 8 x 8 image positions
    axial = np.tril(np.ones((n, n), bool)) & build_static_mask("axial_row", n, 8, 1)[:n, :n]
    arms = (("wide causal", 2, 2, 100, 100, None), ("wide all keys", 2, 2, 100, 150, None),
            ("wide axial_row", 1, 2, n, n, axial))
    cases = [(d, dtype, *arm) for d in WIDE_ATTENTION_DIMS for dtype in (torch.bfloat16, torch.float32)
             for arm in arms]
    cases += [(d, torch.float32, *arm) for d in WIDE_ODD_DIMS for arm in arms]
    cases += [(d, dtype, "wide causal, training shapes", TRAIN["batch"], TRAIN["heads"], TRAIN["n"],
               TRAIN["n"], None) for d in WIDE_TIMED_DIMS for dtype in (torch.bfloat16, torch.float32)]
    worst = {}
    for d, dtype, label, b, h, n_q, n_k, mask in cases:
        t0 = time.perf_counter()
        errs = attention_case(torch, label, b, h, n_q, n_k, d, dtype, mask=mask,
                              causal=label != "wide all keys")
        if dtype == torch.float32 and (d in WIDE_ODD_DIMS or n_q == TRAIN["n"]):
            print(f"  (that fp32 case took {time.perf_counter() - t0:.1f} s)")
        worst_of = worst.setdefault("bf16" if dtype == torch.bfloat16 else "fp32", {})
        for kernel, err in errs.items():
            worst_of["wide_" + kernel] = max(worst_of.get("wide_" + kernel, 0.0), err)
    return worst


WIDE_DTYPES = (("bf16", 2), ("fp32", 4))  # (peak key, bytes an element) of the timed wide rows
WIDE_SHAPES = ("resume", "prefill")  # the multi-row decode's timed shapes


def time_wide_kernels(torch, F, peaks, smi):
    """Phase 3 for the wide kernels at WIDE_TIMED_DIMS, bf16 and fp32: the
    split-K decode step (B = 4, H = 16, S = 1281, n = 1, lengths [258,
    700, 1024, 1281]; SDPA with the length mask beside it), the multi-row
    decode at the resume and prefill shapes (`time_wide_rows`) and flash
    attention forward and backward at TRAIN's causal shapes (SDPA's
    forward and its whole backward beside them): kernel, plain and SDPA
    times, the bound at the input type's peak, and (after the last timed
    phase) the device time; then the step at WIDE_STEP_DIM (the split-K
    kernel's wide instance, "wide_step") in both types. Returns {kernel: {(D, "bf16" | "fp32",
    shape): row}}, the multi-row decode under the arm that ran it
    (`fd.decode_arm`)."""
    rows = {"wide_split": {}, "wide_attention_fwd": {}, "wide_attention_bwd": {}}
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for d in WIDE_TIMED_DIMS:
        for key, elt in WIDE_DTYPES:
            rows["wide_split"][(d, key, "step")] = time_wide_step(torch, F, peaks, smi, d, g, key, elt)
            for shape in WIDE_SHAPES:
                arm, row = time_wide_rows(torch, F, peaks, smi, d, g, key, shape)
                rows.setdefault(arm, {})[(d, key, shape)] = row
            for kind, row in time_wide_attention(torch, F, peaks, smi, d, g, key, elt).items():
                rows[f"wide_attention_{kind}"][(d, key, "train")] = row
    # the step above the split-K kernel's narrow instance: its wide instance
    t0 = time.perf_counter()
    rows["wide_step"] = {(WIDE_STEP_DIM, key, "step"):
                         time_wide_step(torch, F, peaks, smi, WIDE_STEP_DIM, g, key, elt)
                         for key, elt in WIDE_DTYPES}
    print(f"phase 3 step at D = {WIDE_STEP_DIM} (split-K, wide instance), bf16 and fp32: "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


def wide_fields(rows, main_case):
    """A wide kernel's fields in the kernels line from phase 3's rows
    {(D, dtype, shape): row}: the main case's as they are, every other
    case's times and bound under the prefix d<D>_<dtype>_<shape>_."""
    out = {k: v for k, v in rows[main_case].items() if k != "device_kernels"}
    for case, row in rows.items():
        if case != main_case:
            out.update({"d%d_%s_%s_%s" % (*case, k): v for k, v in row.items()
                        if k in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                                 "bound_ms", "bound_by", "cuda_kernel", "library_cuda_kernel")})
    return out


def wide_dtype(torch, key):
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[key]


def time_wide_step(torch, F, peaks, smi, d, g, key, elt):
    """The decode step at head dim `d` in `key`'s type (three input sets
    rotating) on the split-K kernel (`fd.decode_arm`); returns its row."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    b, h, s_len, n = MAIN["batch"], MAIN["heads"], MAIN["cache"], 1
    lengths = [258, 700, 1024, 1281]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s_len, device="cuda")[None, :] <= lens.long()[:, None] - n)[:, None, None, :]

    def library(q, k, v, lens):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    dtype = wide_dtype(torch, key)
    inputs = [
        tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
              for shape in ((b, h, n, d), (b, h, s_len, d), (b, h, s_len, d))) + (lens,)
        for _ in range(3)
    ]
    iters = 60
    row = dict(
        ms=time_ms(torch, fd.flash_decode_attention, inputs, iters),
        plain_ms=time_ms(torch, fd.flash_decode_attention_plain, inputs, iters),
        library_ms=time_ms(torch, library, inputs, iters),
    )
    live = sum(lengths)
    nbytes = 2 * b * h * d * elt + 2 * h * d * elt * live + 4 * b
    t_bytes, t_ops = nbytes / peaks["bytes"], 4 * d * h * live / peaks[key]
    row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    defer_device_time(row, fd.flash_decode_attention, inputs, iters)
    defer_device_time(row, library, inputs, iters, prefix="library_")
    print("time " + json.dumps(dict(kernel=fd.decode_arm(n, dtype, d), case="step", dtype=key, D=d,
                                    lengths=lengths, card=smi, **row)))
    return row


def time_wide_rows(torch, F, peaks, smi, d, g, key, shape):
    """The multi-row wide decode (n > 4 at D > 256) at head dim `d` in
    `key`'s type, B = 4, H = 16, S = 1281, at the resume shape (n = 1280,
    lengths 1280) or the prefill shape (n = 257, lengths 257), two input
    sets rotating: kernel, plain, SDPA's causal forward over the n live
    keys (the same function: every length equals n) and the bound at the
    type's peak; the device time after the last timed phase. Returns
    (the arm that ran, row)."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    b, h, s_len = MAIN["batch"], MAIN["heads"], RESUME["cache"]
    n = RESUME["n"] if shape == "resume" else MAIN["prefill"]
    dtype = wide_dtype(torch, key)
    arm = fd.decode_arm(n, dtype, d)
    lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
    inputs = [tuple(torch.randn(sh, generator=g, device="cuda").to(dtype)
                    for sh in ((b, h, n, d), (b, h, s_len, d), (b, h, s_len, d))) + (lens,)
              for _ in range(2)]
    live = [(q, k[:, :, :n].contiguous(), v[:, :, :n].contiguous()) for q, k, v, _ in inputs]

    def sdpa_causal(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    iters = 4 if shape == "resume" else 20
    row = dict(ms=time_ms(torch, fd.flash_decode_attention, inputs, iters),
               plain_ms=time_ms(torch, fd.flash_decode_attention_plain, inputs, 2),
               library_ms=time_ms(torch, sdpa_causal, live, 10))
    row["bound_ms"], row["bound_by"] = wide_tile_bound(b, h, n, d, peaks, key)
    defer_device_time(row, fd.flash_decode_attention, inputs, iters)
    defer_device_time(row, sdpa_causal, live, 10, prefix="library_")
    print("time " + json.dumps(dict(kernel=arm, case=shape, dtype=key, B=b, H=h, n=n, D=d, S=s_len,
                                    lengths=n, library="SDPA causal forward over the n live keys",
                                    card=smi, **row)))
    return arm, row


def time_wide_attention(torch, F, peaks, smi, d, g, key, elt):
    """Flash attention's forward and backward at head dim `d` in `key`'s
    type at TRAIN's causal shapes (two input sets rotating), SDPA's causal
    forward and whole backward beside them. Returns {"fwd" | "bwd": row}."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import wide_head as wh

    dtype = wide_dtype(torch, key)
    bt, ht, nt = TRAIN["batch"], TRAIN["heads"], TRAIN["n"]
    sets = []
    for _ in range(2):
        q, k, v, do = (torch.randn(bt, ht, nt, d, generator=g, device="cuda").to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
    fwd_in = [s[:3] for s in sets]
    lib_bwd_in = []
    for q, k, v, do, _, _ in sets:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_bwd_in.append((F.scaled_dot_product_attention(*leaves, is_causal=True), *leaves, do))

    def lib_fwd(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def lib_bwd(out, q, k, v, do):
        return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)

    named = wh.wide_attention_kernels(d, dtype)
    out = {}
    for kind, fn, plain, lib, ins, lib_in in (
        ("fwd", fa.flash_attention_fwd, fa.flash_attention_forward_plain, lib_fwd, fwd_in, fwd_in),
        ("bwd", fa.flash_attention_bwd, fa.flash_attention_bwd_plain, lib_bwd, sets, lib_bwd_in),
    ):
        row = dict(ms=time_ms(torch, fn, ins, 4), plain_ms=time_ms(torch, plain, ins, 2),
                   library_ms=time_ms(torch, lib, lib_in, 10))
        row["bound_ms"], row["bound_by"] = attention_bound(kind, elt, peaks, key, d)
        row["cuda_kernel"] = named[kind] if kind == "fwd" else " + ".join(named[kind])
        if dtype == torch.bfloat16:
            row["groups"] = wh.wide_attention_plan(d, kind).groups
        defer_device_time(row, fn, ins, 4)
        defer_device_time(row, lib, lib_in, 10, prefix="library_")
        out[kind] = row
        print("time " + json.dumps(dict(kernel=f"wide_attention_{kind}", dtype=key, B=bt, H=ht, N=nt,
                                        D=d, causal=True, card=smi, **row)))
    return out


def wide_tile_bound(b, h, n, d, peaks, key="bf16"):
    """(bound_ms, bound_by) of a multi-row decode call of n rows over n
    live keys each (every length n) at head dim `d` in `key`'s type: q, K,
    V read and out written once; 4*D flops per visible (row, key) pair, n
    (n + 1) / 2 of them a (row, head), at the type's peak."""
    elt = dict(WIDE_DTYPES)[key]
    nbytes = 4 * b * h * n * d * elt + 4 * b
    flops = 4 * d * b * h * n * (n + 1) / 2
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / peaks[key]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


# ------------------------------------------------ the resume forward's shape

# `DALLE.decode_resume`: text_len + image_seq_len - 1 query rows over a
# fresh total_seq_len + 1 cache, every row causal over the prefix
RESUME = dict(n=1280, cache=1281)


def resume_inputs(torch, b, dtype, copies=1, d=MAIN["dim_head"]):
    """`copies` (q, k, v, lengths) sets at the resume shape, B = `b`, head
    dim `d`."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    h, n, s = MAIN["heads"], RESUME["n"], RESUME["cache"]
    lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
    return [
        tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
              for shape in ((b, h, n, d), (b, h, s, d), (b, h, s, d))) + (lens,)
        for _ in range(copies)
    ]


def tile_bound(b, n, lengths, s_len, per_pos_bytes, peaks, elt=2, dtype_key="bf16"):
    """(bound_ms, bound_by) of one multi-row decode call at MAIN's heads
    and head dim: q read and out written at `elt` bytes an element, each
    row's live cache positions read once at `per_pos_bytes` per position
    and head, lengths; 4*D flops per visible (query row, key) pair at the
    `dtype_key` peak."""
    h, d = MAIN["heads"], MAIN["dim_head"]
    live = [min(max(x, 0), s_len) for x in lengths]
    pairs = sum(max(0, min(x - n + i + 1, s_len)) for x in live for i in range(n))
    nbytes = 2 * b * h * n * d * elt + h * per_pos_bytes * sum(live) + 4 * b
    flops = 4 * d * h * pairs
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / peaks[dtype_key]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_tile_arm(torch, F, peaks, smi, cases):
    """Phase 3 for the tile arm in bf16 (B = 4, inputs rotating over LAYERS
    copies) at the prefill chunk (n = 257 over the 1281-slot cache,
    lengths 257) and the resume forward (n = 1280, S = 1281, lengths
    1280): kernels 1 and 2 (int8) through the tile arm, their plain
    versions, SDPA's causal forward over the n live keys (the same
    function: every length equals n) and row 6's kernel
    (`flash_attention_fwd`, causal) on those keys; the device times of the
    tile arm and of row 6's kernel are taken after phase 10. Returns
    {"prefill" | "resume": {"flash_decode_tile" | "flash_decode_tile_int8": row}}."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    b, d = MAIN["batch"], MAIN["dim_head"]

    def sdpa_causal(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    out = {}
    for shape in ("prefill", "resume"):
        if shape == "prefill":
            n, lengths = cases["prefill"]
            s_len, iters = MAIN["cache"], 10 * LAYERS
            inputs = flash_inputs(torch, n, lengths, torch.bfloat16, copies=LAYERS)
        else:
            n, s_len, iters = RESUME["n"], RESUME["cache"], 2 * LAYERS
            lengths = [n] * b
            inputs = resume_inputs(torch, b, torch.bfloat16, copies=LAYERS)
        live = [(q, k[:, :, :n].contiguous(), v[:, :, :n].contiguous()) for q, k, v, _ in inputs]
        int8_in = []
        for q, k, v, lens in inputs:
            kq, vq, ks, vs = quantized(torch, k, v)
            int8_in.append((q, kq, vq, lens, ks, vs))
        library_ms = time_ms(torch, sdpa_causal, live, iters)
        fwd_ms = time_ms(torch, fa.flash_attention_fwd, live, iters)
        rows = {}
        for kernel, args, per_pos in (("flash_decode_tile", inputs, 2 * d * 2),
                                      ("flash_decode_tile_int8", int8_in, 2 * d + 8)):
            row = dict(
                ms=time_ms(torch, fd.flash_decode_attention, args, iters),
                plain_ms=time_ms(torch, fd.flash_decode_attention_plain, args, 6),
                library_ms=library_ms,
                flash_attention_fwd_ms=fwd_ms,
            )
            row["bound_ms"], row["bound_by"] = tile_bound(b, n, lengths, s_len, per_pos, peaks)
            defer_device_time(row, fd.flash_decode_attention, args, iters)
            rows[kernel] = row
            print("time " + json.dumps(dict(
                kernel=kernel, case=shape, q_dtype="bf16", B=b, H=MAIN["heads"], n=n, D=d,
                S=s_len, lengths=lengths[0], library="SDPA causal forward over the n live keys",
                card=smi, **row)))
        defer_device_time(rows["flash_decode_tile"], fa.flash_attention_fwd, live, iters,
                          prefix="flash_attention_fwd_")
        out[shape] = rows
    return out


def time_tile_variants(torch, F, peaks, smi, d=MAIN["dim_head"], dtype=None):
    """Phase 3 for kernels 3-5 through the multi-row arm of q's `dtype`
    (bf16: the tile arm, at D = `d` > 256 the tile kernel of
    csrc/wide_decode_tile.cu; fp32 at D > 256: `wide_decode_fma_kernel`,
    with kernel 2, the int8 cache, beside) at the resume shape (n = 1280,
    S = 1281, lengths 1280, B = 4, H = 16, D = `d`): kernel 3 with a random
    bitmap of 128-position blocks (block 0 and the last live), kernel 4
    over a shuffled pool of 32-position pages, kernel 5 with a random page
    bitmap (the first two pages live); each beside its plain version and
    SDPA with the same mask (over the cache gathered beforehand for 4 and
    5; kernel 2's over the cache it quantizes), and its bound over the
    visible pairs at the type's peak; the device times after phase 10.
    Returns {kernel: row}."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd
    from dalle_pytorch_tpu_torch.ops import wide_head as wh

    dtype = dtype or torch.bfloat16
    key, elt = ("bf16", 2) if dtype == torch.bfloat16 else ("fp32", 4)
    arm = fd.decode_arm(RESUME["n"], dtype, d)
    b, h, n, s_len = MAIN["batch"], MAIN["heads"], RESUME["n"], RESUME["cache"]
    lengths, copies = [n] * b, 3  # three input sets rotating: 3 x 21 MB of K/V (D = 64) passes the L2
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    bm = (torch.rand((b, -(-s_len // 128)), generator=g, device="cuda") < 0.5).to(torch.int32)
    bm[:, 0] = bm[:, -1] = 1
    pbm = (torch.rand((b, -(-s_len // PAGE)), generator=g, device="cuda") < 0.5).to(torch.int32)
    pbm[:, :2] = 1
    lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
    causal = (torch.arange(s_len, device="cuda")[None, None, :]
              <= (lens.long()[:, None] - n + torch.arange(n, device="cuda")[None, :])[:, :, None])
    masks = {"block_sparse_flash_decode": causal & fd.expand_bitmap(bm, 128, s_len)[:, None, :],
             "paged_flash_decode": causal,
             "block_sparse_paged_flash_decode": causal & fd.expand_bitmap(pbm, PAGE, s_len)[:, None, :]}
    if dtype == torch.float32:
        masks = {"flash_decode_int8": causal, **masks}
    sets = {name: ([], []) for name in masks}  # (kernel args, library args) per copy
    for i, (q, k, v, _) in enumerate(resume_inputs(torch, b, dtype, copies=copies, d=d)):
        if "flash_decode_int8" in sets:
            kq, vq, ks, vs = quantized(torch, k, v)
            sets["flash_decode_int8"][0].append((q, kq, vq, lens, ks, vs))
            sets["flash_decode_int8"][1].append((q, k, v, masks["flash_decode_int8"]))
        sets["block_sparse_flash_decode"][0].append((q, k, v, lens, bm, 128))
        sets["block_sparse_flash_decode"][1].append((q, k, v, masks["block_sparse_flash_decode"]))
        pq, pk, pv, _, table, _ = paged_case(torch, b, h, n, d, PAGE, lengths, dtype, s_len,
                                             SEED + 12 + i)
        kg, vg = fd.paged_gather(pk, table, s_len), fd.paged_gather(pv, table, s_len)
        sets["paged_flash_decode"][0].append((pq, pk, pv, lens, table))
        sets["paged_flash_decode"][1].append((pq, kg, vg, masks["paged_flash_decode"]))
        sets["block_sparse_paged_flash_decode"][0].append((pq, pk, pv, lens, table, pbm))
        sets["block_sparse_paged_flash_decode"][1].append((pq, kg, vg, masks["block_sparse_paged_flash_decode"]))

    def sdpa_masked(q_, k_, v_, mask):
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask[:, None])

    fns = {"flash_decode_int8": (fd.flash_decode_attention, fd.flash_decode_attention_plain),
           "block_sparse_flash_decode": (fd.block_sparse_flash_decode_attention,
                                         fd.block_sparse_flash_decode_attention_plain),
           "paged_flash_decode": (fd.paged_flash_decode_attention, fd.paged_flash_decode_attention_plain),
           "block_sparse_paged_flash_decode": (fd.block_sparse_paged_flash_decode_attention,
                                               fd.block_sparse_paged_flash_decode_attention_plain)}

    def arm_launches():
        if arm == "wide_tile_f32":
            return wh.wide_decode.tile_f32_launches
        return tile_launches() + wh.wide_decode.tile_launches

    rows = {}
    for kernel in masks:
        fn, plain = fns[kernel]
        args, lib_args = sets[kernel]
        before = arm_launches()
        fn(*args[0])
        if arm_launches() - before != 1:
            fail(f"{kernel} at the resume shape (D = {d}, {key}) did not launch the {arm} arm")
        pairs = int(masks[kernel].sum())
        live_keys = int(masks[kernel].any(1).sum())  # keys some row sees, over the batch rows
        per_key = 2 * d + 8 if kernel.endswith("int8") else 2 * d * elt  # K and V (int8: and scales)
        nbytes = 2 * b * h * n * d * elt + h * per_key * live_keys + 4 * b
        t_bytes, t_ops = nbytes / peaks["bytes"], 4 * d * h * pairs / peaks[key]
        row = dict(ms=time_ms(torch, fn, args, 2 * LAYERS), plain_ms=time_ms(torch, plain, args, 4),
                   library_ms=time_ms(torch, sdpa_masked, lib_args, 2 * LAYERS),
                   bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        defer_device_time(row, fn, args, 2 * LAYERS)
        rows[kernel] = row
        print("time " + json.dumps(dict(kernel=kernel, arm=arm, case="resume", q_dtype=key, B=b, H=h,
                                        n=n, D=d, S=s_len, lengths=n, visible_pairs=pairs,
                                        library="SDPA with the same boolean mask", card=smi, **row)))
    return rows


def time_tile_f32_arm(torch, F, peaks, smi, cases):
    """Phase 3 for flash decode's fp32 tile arm (`csrc/flash_decode_tile_f32.cu`,
    fp32 q at n > 4) at the prefill chunk (n = 257 over the 1281-slot
    cache, lengths 257) and the resume shape (n = 1280, S = 1281, lengths
    1280), B = 4, inputs rotating over LAYERS copies: kernels 1 and 2
    (int8), their plain versions, SDPA's causal forward in fp32 over the n
    live keys (the same function: every length equals n) and the bound at
    the fp32 peak; the device times (the kernel's and SDPA's) are taken
    after phase 10. Returns {"prefill" | "resume": {"flash_decode_tile_f32"
    | "flash_decode_tile_f32_int8": row}}."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    b, d = MAIN["batch"], MAIN["dim_head"]
    if fd.decode_arm(RESUME["n"], torch.float32, d) != "tile_f32":
        fail(f"fp32 q at n = {RESUME['n']} does not take the fp32 tile arm")

    def sdpa_causal(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    out = {}
    for shape in ("prefill", "resume"):
        if shape == "prefill":
            n, _ = cases["prefill"]
            s_len, iters = MAIN["cache"], 4 * LAYERS
            inputs = flash_inputs(torch, n, [n] * b, torch.float32, copies=LAYERS)
        else:
            n, s_len, iters = RESUME["n"], RESUME["cache"], LAYERS
            inputs = resume_inputs(torch, b, torch.float32, copies=LAYERS)
        live = [(q, k[:, :, :n].contiguous(), v[:, :, :n].contiguous()) for q, k, v, _ in inputs]
        int8_in = []
        for q, k, v, lens in inputs:
            kq, vq, ks, vs = quantized(torch, k, v)
            int8_in.append((q, kq, vq, lens, ks, vs))
        lib_err = (sdpa_causal(*live[0]) - fd.flash_decode_attention_plain(*inputs[0])).abs().max().item()
        library_ms = time_ms(torch, sdpa_causal, live, iters)
        rows = {}
        for kernel, args, per_pos in (("flash_decode_tile_f32", inputs, 2 * d * 4),
                                      ("flash_decode_tile_f32_int8", int8_in, 2 * d + 8)):
            row = dict(
                ms=time_ms(torch, fd.flash_decode_attention, args, iters),
                plain_ms=time_ms(torch, fd.flash_decode_attention_plain, args, 4),
                library_ms=library_ms,
            )
            row["bound_ms"], row["bound_by"] = tile_bound(b, n, [n] * b, s_len, per_pos, peaks, 4, "fp32")
            defer_device_time(row, fd.flash_decode_attention, args, iters)
            rows[kernel] = row
            print("time " + json.dumps(dict(
                kernel=kernel, case=shape, q_dtype="fp32", B=b, H=MAIN["heads"], n=n, D=d, S=s_len,
                lengths=n, library="SDPA causal forward in fp32 over the n live keys",
                library_max_abs_err=lib_err, card=smi, **row)))
        defer_device_time(rows["flash_decode_tile_f32"], sdpa_causal, live, iters, prefix="library_")
        out[shape] = rows
        del inputs, live, int8_in
    return out


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
    # the tile arms over several query and key tiles, one row's length below n
    cases += [(4, 2, 130, 64, 300, [100, 131, 200, 300])]
    cases += [(4, 2, 65, 200, 300, [60, 131, 200, 300])]  # fp32: 32-key tiles
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tile_before = {arm: tile_launches(arm) for arm in ("tile", "tile_f32")}
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
    held["tile arm launches"] = tile_launches() - tile_before["tile"]
    held["fp32 tile arm launches"] = tile_launches("tile_f32") - tile_before["tile_f32"]
    print("check paged bit identities (cases held): " + json.dumps(held))
    if held["tile arm launches"] == 0 or held["fp32 tile arm launches"] == 0:
        failures.append("no call launched the tile arm or the fp32 tile arm")
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
    plain version (o and dv against the latter, at a D the wide kernels
    zero-pad, per tile to ATTN_TOL's limit plus one rounding flip of that
    tile, `flip_allowance`). The backward takes the kernel forward's lse and delta,
    and runs twice: dk and dv must be bit-identical (no atomics), and dq in
    float32 (each output written once); bf16 dq's run-to-run difference (the
    order of its atomic adds) is printed. In float32 the forward runs twice
    too: o and lse must be bit-identical. In float32 at D <= 256 the
    forward is also held to its TF32 split's model
    (`flash_attention_forward_tf32x3_plain`) under ATTN_TOL["fp32"]
    ("split_model_fwd"), and the backward set beside its model
    (`flash_attention_bwd_tf32x3_plain`; printed, "split_model", with the
    model's own distance from the exact version). Returns {kernel:
    max_abs_err against the exact version}."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    errs = {}
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(b, h, n_q, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, h, n_k, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    fm = None if mask is None else fa.flash_mask(mask, "cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, fm, causal)
    fwd_twice = dtype == torch.float32
    if fwd_twice:
        o2, lse2 = fa.flash_attention_fwd(q, k, v, fm, causal)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"flash_attention_fwd {label} {dtype} D={d}: o or lse differ between two runs")
    delta = (do.float() * o.float()).sum(-1)
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, fm, causal)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, fm, causal)
    torch.cuda.synchronize()
    outs = {"fwd": (o, lse), "bwd": grads}
    dq_rerun = (grads[0].float() - again[0].float()).abs().max().item()
    if not (torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])):
        fail(f"flash_attention_bwd {label} {dtype}: dk or dv differ between two runs")
    if dtype == torch.float32 and not torch.equal(grads[0], again[0]):
        fail(f"flash_attention_bwd {label} {dtype}: dq differs between two runs")

    def plain(p_dtype):
        return {
            "fwd": fa.flash_attention_forward_plain(q, k, v, fm, causal, p_dtype=p_dtype),
            "bwd": fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, fm, causal,
                                                p_dtype=p_dtype),
        }

    refs = {"exact": plain(None)}
    flips = {}
    if dtype == torch.float32 and d <= 256:  # the TF32 kernels: their arithmetic's model
        model = fa.flash_attention_bwd_tf32x3_plain(q, k, v, do, lse, delta, fm, causal)
        errs["split_model"] = max((a - b).abs().max().item() for a, b in zip(grads, model))
        errs["split_model_vs_exact"] = max((a - b).abs().max().item()
                                           for a, b in zip(model, refs["exact"]["bwd"]))
        errs["split_model_fwd"] = 0.0
        el_tol, tile_tol = ATTN_TOL["fp32"]
        for name, out, ref in zip(("o", "lse"), (o, lse), fa.flash_attention_forward_tf32x3_plain(q, k, v, fm, causal)):
            err, element, tile = attention_closeness(torch, out, ref)
            errs["split_model_fwd"] = max(errs["split_model_fwd"], err)
            if not (element <= el_tol and tile <= tile_tol):
                fail(f"flash_attention_fwd {label} D={d}: {name} against the split model: element "
                     f"{element:.3e}, tile {tile:.3e} over fp32 ({el_tol}, {tile_tol})")
    if dtype == torch.bfloat16:
        from dalle_pytorch_tpu_torch.ops import wide_head as wh

        refs["matched"] = plain(torch.bfloat16)
        if d > wh.WIDE_ABOVE and wh.wide_kernel_head_dim(d, dtype) != d:
            flips["o"], flips["dv"] = flip_allowance(torch, q, k, v, do, lse, mask, causal,
                                                     refs["matched"]["fwd"][0], refs["matched"]["bwd"][2])
    report, failures = [], []
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
                el_tol, tile_tol = ATTN_TOL[tol_key]
                if tol_key == "bf16_matched_p" and tensor in flips:
                    err, element, tile, tile_tol, pairs = attention_closeness(
                        torch, out, r, tile_tol + flips[tensor])
                    report.append(f"{tensor}/{ref_kind} {element:.1e}, each tile's ratio / limit (1e-3 + "
                                  "one flip): " + " ".join(f"{x:.2e}/{y:.2e}" for x, y in pairs))
                else:
                    err, element, tile = attention_closeness(torch, out, r)
                    report.append(f"{tensor}/{ref_kind} {element:.1e} {tile:.1e}")
                if not ((el_tol is None or element <= el_tol) and tile <= tile_tol):
                    failures.append(
                        f"{name} {tensor} vs the {ref_kind} plain version: element "
                        f"{element:.3e}, tile {tile:.3e} over {tol_key} ({el_tol}, {tile_tol:.3e})"
                    )
                if ref_kind == "exact":
                    errs[name] = max(errs.get(name, 0.0), err)
    print(
        f"check flash_attention {label} {str(dtype)[6:]} B={b} H={h} nq={n_q} nk={n_k} D={d}: "
        + ", ".join(f"{k.removeprefix('flash_attention_')} {e:.3e}" for k, e in errs.items())
        + f" max_abs_err; {'o, lse, ' if fwd_twice else ''}dk, dv{', dq' if dtype == torch.float32 else ''} "
        f"bit-identical over two runs, dq run-to-run {dq_rerun:.3e}"
        + "; element, tile ratios: " + "; ".join(report)
    )
    if failures:
        fail(f"flash_attention {label} {dtype}: " + "; ".join(failures))
    return errs


def check_attention(torch):
    """Phase 2 for flash attention; returns {"bf16" | "fp32": {kernel:
    worst error}} (fp32 also the worst distance from the split's model)."""
    import numpy as np

    from dalle_pytorch_tpu_torch.models.transformer import build_static_mask

    b, h, n, d = TRAIN["batch"], TRAIN["heads"], TRAIN["n"], TRAIN["dim_head"]
    axial = np.tril(np.ones((n, n), bool)) & build_static_mask("axial_row", n, 32, 1)[:n, :n]
    small_n = 160  # 97 text + 8 x 8 image positions
    small_axial = np.tril(np.ones((small_n, small_n), bool)) & build_static_mask(
        "axial_row", small_n, 8, 1)[:small_n, :small_n]
    print(f"check flash_attention limits (element, tile): {json.dumps(ATTN_TOL)}")
    worst = {"bf16": {}, "fp32": {}}
    for dtype in (torch.bfloat16, torch.float32):
        cases = [
            ("causal", b, h, n, n, d, None),
            ("ragged", b, h, 1000, 1000, d, None),
            ("axial_row", b, h, n, n, d, axial),
            ("nk>nq", 2, 2, 70, 150, d, None),
            ("all keys", 2, 2, 100, 150, d, None),  # the arm without causality or mask
        ] + [("small", 2, 2, 100, 100, dd, None) for dd in ATTENTION_OTHER_DIMS]
        # fp32: the other two arms at a padded D and the widest instance
        cases += [(arm, *shape, dd, mask) for dd in ATTENTION_ARM_DIMS if dtype == torch.float32
                  for arm, *shape, mask in (("all keys", 2, 2, 100, 150, None),
                                            ("axial_row", 1, 2, small_n, small_n, small_axial))]
        for label, *shape, mask in cases:
            t_case = time.perf_counter()
            errs = attention_case(torch, label, *shape, dtype, mask=mask,
                                  causal=label != "all keys")
            if shape[-1] in ATTENTION_ARM_DIMS and label != "small":
                print(f"  (that case took {time.perf_counter() - t_case:.1f} s)")
            of = worst["bf16" if dtype == torch.bfloat16 else "fp32"]
            for kernel, err in errs.items():
                of[kernel] = max(of.get(kernel, 0.0), err)
    print("check flash_attention fp32 backward (TF32 passes) worst |kernel - split model| "
          f"{worst['fp32']['split_model']:.3e}, |split model - exact| "
          f"{worst['fp32']['split_model_vs_exact']:.3e}, |kernel - exact| "
          f"{worst['fp32']['flash_attention_bwd']:.3e}; fp32 forward (fwd_tf32_kernel) worst "
          f"|kernel - split model| {worst['fp32']['split_model_fwd']:.3e}, |kernel - exact| "
          f"{worst['fp32']['flash_attention_fwd']:.3e}")
    return worst


def time_attention(torch, F, peaks, dtype, key, elt, d=TRAIN["dim_head"]):
    """Kernel, plain and library times of the two passes at TRAIN's causal
    shapes (head dim `d`; inputs rotate over 3 copies). SDPA's backward
    computes dq, dk and dv in one call, its own delta included, so beside
    the backward kernel the row also times the port's whole backward as
    the autograd Function runs it (delta, then the wrapper: workspace
    zeroing, the kernel, dq's conversion). The device times of the kernels
    and of SDPA (`device_ms`, `library_device_ms`), both dtypes, are taken
    after the last timed phase."""
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
    for name, fn, lib, ins, lib_in in (
        ("flash_attention_fwd", fa.flash_attention_fwd, lib_fwd, fwd_in, fwd_in),
        ("flash_attention_bwd", fa.flash_attention_bwd, lib_bwd, sets, lib_bwd_in),
    ):
        defer_device_time(rows[name], fn, ins, 30)
        defer_device_time(rows[name], lib, lib_in, 30, prefix="library_")
    for name, row in rows.items():
        bound_key = "tf32x3" if key == "fp32" and d <= 256 else key
        row["bound_ms"], row["bound_by"] = attention_bound(name[16:], elt, peaks, bound_key, d)
        print("time " + json.dumps(dict(kernel=name, dtype=key, B=b, H=h, N=n, D=d, causal=True,
                                        bound_at=bound_key, **row)))
    bwd = rows["flash_attention_bwd"]
    print(
        f"time flash_attention backward {key}: kernel {bwd['ms']:.4f} ms, whole backward "
        f"{bwd['whole_backward_ms']:.4f} ms, SDPA backward {bwd['library_ms']:.4f} ms, "
        f"bound {bwd['bound_ms']:.4f} ms"
    )
    return rows


def sdpa_over_lengths(q, k, v, lens):
    """SDPA computing flash decode's function: q's n rows as the last n
    positions of each row's `lens`, causal over the cache."""
    import torch
    import torch.nn.functional as F

    n, s = q.shape[2], k.shape[2]
    bound = lens.long()[:, None] - n + torch.arange(n, device=q.device)[None, :]
    mask = torch.arange(s, device=q.device)[None, None, :] <= bound[:, :, None]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None])


def time_decode(torch, peaks, dtype, key, elt, case, n, lengths):
    """Phase 3 for flash decode at D <= 256 (MAIN's shapes, LAYERS input
    sets rotating): kernel, plain and SDPA (`sdpa_over_lengths`) times and
    the bound; the device times of the kernel, and at the step of SDPA,
    after the last timed phase. Returns the row."""
    from dalle_pytorch_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
    )

    inputs = flash_inputs(torch, n, lengths, dtype, copies=LAYERS)
    iters = 10 * LAYERS if case == "prefill" else 40 * LAYERS
    lib_err = (sdpa_over_lengths(*inputs[0]).float()
               - flash_decode_attention_plain(*inputs[0]).float()).abs().max().item()
    row = dict(
        ms=time_ms(torch, flash_decode_attention, inputs, iters),
        plain_ms=time_ms(torch, flash_decode_attention_plain, inputs, iters),
        library_ms=time_ms(torch, sdpa_over_lengths, inputs, iters),
    )
    row["bound_ms"], row["bound_by"] = flash_bound(n, lengths, elt, peaks, key)
    defer_device_time(row, flash_decode_attention, inputs, iters)
    if case == "step":
        defer_device_time(row, sdpa_over_lengths, inputs, iters, prefix="library_")
    print("time " + json.dumps(dict(
        kernel="flash_decode", case=case, dtype=key, n=n, lengths=lengths,
        library_max_abs_err=lib_err, **row,
    )))
    return row


# phase 4's bf16 decode check (both paths in bf16: the kernels round
# their output once, dense attention its scores, softmax and output): the
# logits within 2^-5 of max(1, the largest |logit|), a few bf16 roundings
# (2^-8 each) through the depth-2 model
BF16_DECODE_TOL = 2.0**-5


def check_small_model_decode(torch, dim_head, dtype=None):
    """Phase 4, decode: a small DALLE (head dim `dim_head`; float32, or
    its weights cast to `dtype`) through the kernels and through dense
    attention, same weights: logits of the prefill, 64 cached steps and a
    resume (`decode_resume` of both rows at image positions 40 and 63, n =
    80 query rows) within 1e-4 in float32, BF16_DECODE_TOL in bf16."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE, init_decode_cache

    small = dict(
        dim=128, depth=2, heads=2, dim_head=dim_head, num_image_tokens=64, image_fmap_size=8,
        num_text_tokens=100, text_seq_len=16, shift_tokens=True, rotary_emb=True,
    )
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        flash_model = DALLE(**small, attn_impl="flash").eval()
        dense_model = DALLE(**small, attn_impl="dense").eval()
    dense_model.load_state_dict(flash_model.state_dict())
    if dtype is not None:
        flash_model, dense_model = flash_model.to(dtype), dense_model.to(dtype)
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
        pos = torch.tensor([40, 63], device="cuda")
        rows = [m.decode_resume(text, img, pos, init_decode_cache(m, 2))[0]
                for m in (flash_model, dense_model)]
        worst = max(worst, (rows[0] - rows[1]).abs().max().item())
        largest = rows[1].float().abs().max().item()
    tol = 1e-4 if dtype is None else BF16_DECODE_TOL * max(1.0, largest)
    kind = "fp32" if dtype is None else str(dtype)[6:]
    print(
        f"check model {kind} dim_head {dim_head} kernel-vs-dense logits over prefill + 64 steps + "
        f"resume: max_abs_err {worst:.3e} tol {tol:.3e}"
    )
    if not worst <= tol:
        fail(f"the small model's {kind} kernel path disagrees with its dense path")


# phase 4's bf16 training check (bf16 autocast on both paths, which round
# at different places: the kernels P and dS, dense attention its softmax
# output): the loss within 1e-2 relative and each gradient within 5e-2 of
# the dense path's norm, ~6 roundings of bf16's 2^-8 over a depth-2 model
BF16_MODEL_TOL = dict(loss=1e-2, grad=5e-2)
# forward and backward calls of one fp32 training check: one per attention
# layer (2) per model call of the forward_reverse_partial objective (2)
FP32_TRAINING_FWD = FP32_TRAINING_BWD = 4


def check_small_model_training(torch, dim_head, autocast_dtype=None):
    """Phase 4, training: a small float32 DALLE (full + axial_row layers,
    n = 80, two 64-row tiles) through the flash kernels and through dense
    attention, same weights: loss and every gradient of the
    forward_reverse_partial objective within 1e-4; under bf16 autocast
    (`autocast_dtype`, the bf16 kernels) within BF16_MODEL_TOL."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.training.steps import accumulate_gradients, make_dalle_loss

    small = dict(
        dim=128, depth=2, heads=2, dim_head=dim_head, num_image_tokens=64, image_fmap_size=8,
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
        metrics = accumulate_gradients(m, make_dalle_loss(m, "forward_reverse_partial"), batch,
                                       autocast_dtype=autocast_dtype)
        results.append((metrics["loss"].item(), [p.grad for p in m.parameters()]))
    loss_err = abs(results[0][0] - results[1][0])
    if autocast_dtype is None:
        grad_err = max((a - b).abs().max().item() for a, b in zip(results[0][1], results[1][1]))
        tol, ok = "tol 1e-4", loss_err <= 1e-4 and grad_err <= 1e-4
    else:
        loss_err /= abs(results[1][0])
        grad_err = max(((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                       for a, b in zip(results[0][1], results[1][1]))
        tol = f"relative, tol {json.dumps(BF16_MODEL_TOL)}"
        ok = loss_err <= BF16_MODEL_TOL["loss"] and grad_err <= BF16_MODEL_TOL["grad"]
    kind = "fp32" if autocast_dtype is None else "bf16 autocast"
    print(
        f"check model {kind} dim_head {dim_head} training kernel-vs-dense "
        f"(forward_reverse_partial): loss "
        f"{results[0][0]:.6f} err {loss_err:.3e}, worst gradient err {grad_err:.3e}, {tol}"
    )
    if not ok:
        fail(f"the small model's {kind} training loss or gradients disagree between kernels and dense")


def default_vocab() -> int:
    """The text vocabulary of a checkpoint whose config names none: the
    default tokenizer's (the shipped 32k native BPE)."""
    from dalle_pytorch_tpu_torch.data.tokenizer import NativeBPETokenizer, get_tokenizer

    tok = get_tokenizer()
    if not isinstance(tok, NativeBPETokenizer):
        fail(f"the default vocabulary did not load: got {type(tok).__name__}")
    return tok.vocab_size


def flagship_training():
    """(DALLE, batch): the flagship DALLE on the card with float32
    parameters from SEED, attn_impl "auto", the default vocabulary's text
    embedding (its checkpoint names no vocabulary, so the engine serving
    it takes the default tokenizer), and a batch of 4 seeded text and
    image-token rows (text padded from position 200)."""
    import numpy as np
    import torch

    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    torch.manual_seed(SEED)
    vocab = default_vocab()
    with torch.device("cuda"):
        model = DALLE(**{**FLAGSHIP, "num_text_tokens": vocab}, attn_impl="auto")
    rng = np.random.RandomState(SEED)
    text = rng.randint(1, vocab, (4, FLAGSHIP["text_seq_len"]))
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


FP32_TRAIN_STEPS = 3


def run_fp32_training(torch):
    """Phase 6b: the flagship DALLE trained in float32 (float32
    parameters, no autocast, attn_impl "auto": N = 1280 takes the flash
    kernels, the fp32 forward and the fp32 backward's TF32 passes), one
    warmup step, then FP32_TRAIN_STEPS Adam steps on the same batch: ms a
    step by CUDA events, the flash-attention calls counted from zero around
    them (LAYERS a step each), the kernels they launch named by
    `attention_kernels`; the loss must be finite and fall. Returns the
    summary."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.training.steps import make_dalle_train_step, make_optimizer

    model, batch = flagship_training()
    opt = make_optimizer(model.parameters(), 3e-4, clip_grad_norm=0.5)
    step = make_dalle_train_step(model, opt, mode="forward_only", autocast_dtype=None)
    step(batch)
    torch.cuda.synchronize()
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = [step(batch) for _ in range(FP32_TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    losses = [m["loss"].item() for m in metrics]
    summary = dict(ms_per_step=start.elapsed_time(end) / FP32_TRAIN_STEPS, losses=losses,
                   launches=launches, kernels=fa.attention_kernels(FLAGSHIP["dim_head"], torch.float32),
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    print("fp32 training " + json.dumps(summary))
    del model, opt, step
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"the fp32 training loss is not finite or did not fall: {losses}")
    for name, n in launches.items():
        if n != LAYERS * FP32_TRAIN_STEPS:
            fail(f"{name} launched {n} times in {FP32_TRAIN_STEPS} fp32 steps, expected "
                 f"{LAYERS * FP32_TRAIN_STEPS}")
    return summary


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
        setattr(fn, "tile_" + attr, 0)
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
    # of those, the tile arm's (the prefill waves')
    launches.update({name + "_tile": getattr(fn, "tile_" + attr) for name, (fn, attr) in counters.items()})
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
    tokens, and the depth-cut model's causal and int8 runs' tokens)."""
    import copy

    import numpy as np

    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.serving.engine import GenerationEngine

    def only(launches, kernel, expected, label):
        """`kernel` alone launched, `expected` times in all; of those one
        tile-arm launch a layer for each prefill wave (n = 257)."""
        others = {k: n for k, n in launches.items() if k != kernel and not k.endswith("_tile") and n}
        tile = launches[kernel + "_tile"]
        if launches[kernel] != expected or others or tile != engine.model.depth * engine.stats.prefill_dispatches:
            fail(f"continuous {label}: {kernel} launched {launches[kernel]} times "
                 f"(expected {expected}; tile arm {tile}), others {others}")

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
    out["flash_decode_int8"] = launches["flash_decode_int8"] - launches["flash_decode_int8_tile"]
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
    out["block_sparse_flash_decode"] = (launches["block_sparse_flash_decode"]
                                        - launches["block_sparse_flash_decode_tile"])
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
    out["block_sparse_flash_decode_int8"] = (launches["block_sparse_flash_decode_int8"]
                                             - launches["block_sparse_flash_decode_int8_tile"])
    return out, toks1, patterned, toks4, (toks_short, toks2)


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


def run_paged(torch, model, patterned, vae, specs, causal_tokens, patterned_tokens, short_tokens):
    """Phase 8: the three runs of the flagship PagedContinuousEngine.
    Returns {kernel: launches on its run} for kernels 4 and 5."""
    # 1. the reference's default impl: paged_gather + kernel 1, on the
    # model's first SHORT_DEPTH layers (a depth cut that holds the script's
    # time), held to phase 7's causal run of that model
    short = first_layers(torch, model, SHORT_DEPTH)
    label = f"gather causal depth {SHORT_DEPTH}"
    engine, toks1, launches, waves = serve_paged(torch, short, vae, specs, label, paged_decode_impl="gather")
    check_paged_run(engine, toks1, launches, waves, label, "flash_decode", "flash_decode", short_tokens)
    del engine, short

    # 2. kernel 4, with a pool of two rows' worst case beside the prefix
    # cache's four entries (8 full pages and a snapshot page each)
    per_row = -(-(FLAGSHIP["text_seq_len"] + 1024 + 1) // PAGE)  # 41
    text_pages = -(-(FLAGSHIP["text_seq_len"] + 1) // PAGE)  # 9: 8 full and the snapshot
    kv_pages = 1 + 2 * per_row + len(PROMPTS) * text_pages
    engine, toks2, launches, waves = serve_paged(torch, model, vae, specs, "kernel causal, small pool",
                                                 paged_decode_impl="kernel", kv_pages=kv_pages)
    check_paged_run(engine, toks2, launches, waves, "kernel causal, small pool", "paged_flash_decode",
                    "flash_decode", causal_tokens)
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


# phase 9: the generation CLI at flagship width
CLI_PROMPTS = "a red cube|a blue sphere"
CLI_IMAGES = 4  # per prompt, one batch of 4
ORACLE_PRIMED = 1008  # the oracle samples the last 16 image positions
# the noised-score margin above which the uncached oracle must pick the
# cached run's token: twice the largest bf16 logit difference between the
# two paths must stay below it (measured and printed beside it)
ORACLE_MARGIN = 0.1


def run_generation_cli(torch, vae):
    """Phase 9: the generation CLI (`dalle_pytorch_tpu_torch.generate.main`,
    in-process) on a flagship checkpoint whose config names no vocabulary
    (the default 32k native BPE), random weights from SEED, bf16, with
    `vae` inside, and a CLIP checkpoint at the reference defaults: two
    prompts x 4 images with CLIP reranking (4 PNGs and a grid per prompt
    read back with zlib, 12,300 flash-decode launches per batch, scores
    best first), one `--gentxt` run, and the uncached `generate_images`
    oracle primed with the cached run's first ORACLE_PRIMED tokens of
    prompt 0 (the same row seeds, so the last 16 positions sample the same
    noise): 12 flash-attention forwards a sampled position, tokens equal
    to the cached run's wherever the noised-score margin passes
    ORACLE_MARGIN. Returns {counter: launches}."""
    import numpy as np

    from dalle_pytorch_tpu_torch import generate
    from dalle_pytorch_tpu_torch.models.clip import CLIP
    from dalle_pytorch_tpu_torch.models.dalle import (
        DALLE,
        forward_with_cond_scale,
        generate_images,
        init_decode_cache,
    )
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd
    from dalle_pytorch_tpu_torch.training.pipeline import (
        dalle_config,
        dvae_hparams,
        save_clip_checkpoint,
        save_dalle_checkpoint,
    )
    from dalle_pytorch_tpu_torch.utils.images import read_png
    from dalle_pytorch_tpu_torch.weights import export_dvae_params

    vocab = default_vocab()
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    dalle_path, clip_path, out_dir = work / "dalle_cli.npz", work / "clip_cli.npz", work / "cli_outputs"
    t0 = time.perf_counter()
    torch.manual_seed(SEED + 9)
    with torch.device("cuda"):
        model = DALLE(**{**FLAGSHIP, "num_text_tokens": vocab}).to(torch.bfloat16).eval()
        clip = CLIP(num_text_tokens=vocab)
    save_dalle_checkpoint(
        str(dalle_path), dalle_config(model, bf16=True), model,
        vae_params=export_dvae_params(vae), vae_hparams=dvae_hparams(vae),
    )
    save_clip_checkpoint(str(clip_path), clip)
    del clip
    print(f"phase 9 checkpoints (DALLE vocabulary {vocab}, CLIP defaults) written: "
          f"{time.perf_counter() - t0:.1f} s")

    fd.flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    summary = generate.main([
        "--dalle_path", str(dalle_path), "--text", CLI_PROMPTS, "--num_images", str(CLI_IMAGES),
        "--batch_size", str(CLI_IMAGES), "--clip_path", str(clip_path),
        "--outputs_dir", str(out_dir), "--seed", "0",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cli_flash_decode": fd.flash_decode_attention.launches}
    walls = summary["walls"]
    print(f"phase 9 CLI: {wall:.1f} s; stage walls (s) " + json.dumps(
        {k: round(v, 3) for k, v in walls.items()}) + f"; flash_decode launches {launches}")
    prompts = [p.strip() for p in CLI_PROMPTS.split("|")]
    expected = len(prompts) * LAYERS * (1 + FLAGSHIP["image_fmap_size"] ** 2)
    if launches["cli_flash_decode"] != expected:
        fail(f"the CLI launched flash_decode {launches['cli_flash_decode']} times, expected {expected}")
    for entry in summary["prompts"]:
        folder = Path(entry["out_dir"])
        names = sorted(p.name for p in folder.iterdir())
        want = sorted([f"{i}.png" for i in range(CLI_IMAGES)] + ["grid.png"])
        if names != want:
            fail(f"{folder}: files {names}, expected {want}")
        shapes = {n: read_png(folder / n).shape for n in names}
        if any(shapes[f"{i}.png"] != (256, 256, 3) for i in range(CLI_IMAGES)):
            fail(f"{folder}: image shapes {shapes}")
        if shapes["grid.png"] != (256, 256 * CLI_IMAGES, 3):
            fail(f"{folder}: grid shape {shapes['grid.png']}")
        scores = entry["scores"]
        if scores is None or any(a < b for a, b in zip(scores, scores[1:])):
            fail(f"{folder}: CLIP scores not best first: {scores}")
        print(f"check CLI {entry['prompt']!r}: {names} read back with zlib, shapes "
              f"{sorted(set(shapes.values()))}; CLIP scores best first {scores}")

    t0 = time.perf_counter()
    summary_txt = generate.main([
        "--dalle_path", str(dalle_path), "--text", prompts[0], "--num_images", "1",
        "--batch_size", "1", "--gentxt", "--outputs_dir", str(out_dir / "gentxt"), "--seed", "1",
    ])
    completed = summary_txt["prompts"][0]["completed"]
    print(f"phase 9 --gentxt: {time.perf_counter() - t0:.1f} s; completed text {completed!r}")
    if not isinstance(completed, str) or not completed.startswith(prompts[0]):
        fail(f"--gentxt completed text {completed!r} does not extend {prompts[0]!r}")

    # the uncached oracle against the cached run of prompt 0 (rows seeded
    # 0..3 by the CLI: seed 0 spreads to 0)
    tokens = np.asarray(summary["prompts"][0]["tokens"])
    text = torch.tensor(np.repeat(summary["prompts"][0]["text_ids"][None], CLI_IMAGES, 0),
                        device="cuda")
    seeds = list(range(CLI_IMAGES))
    # the two paths' logits at image position 16: cached decode vs one
    # uncached forward over the primed buffer
    probe = min(16, model.image_seq_len - 1)
    with torch.inference_mode():
        cache = init_decode_cache(model, CLI_IMAGES)
        row, cache = model.decode_prefill(text, cache)
        feed = torch.tensor(tokens[:, :probe], device="cuda")
        for i in range(probe):
            row, cache = model.decode_image_step(feed[:, i], i, cache)
        buf = torch.zeros((CLI_IMAGES, model.image_seq_len), dtype=torch.long, device="cuda")
        buf[:, :probe] = feed
        full = forward_with_cond_scale(model, text, buf)[:, model.text_seq_len + probe]
        image_vocab = slice(model.total_text_tokens, None)
        logit_diff = (row[:, image_vocab] - full[:, image_vocab]).abs().max().item()
        del cache, full
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    oracle, margins = generate_images(
        model, text, seed=seeds, filter_thres=0.9, temperature=1.0,
        init_image_tokens=tokens, num_init_img_tokens=ORACLE_PRIMED, return_margins=True,
    )
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    launches["oracle_flash_attention_fwd"] = fa.flash_attention_fwd.launches
    sampled = model.image_seq_len - ORACLE_PRIMED
    oracle = oracle.cpu().numpy()
    differ = np.argwhere(oracle[:, ORACLE_PRIMED:] != tokens[:, ORACLE_PRIMED:])
    margins = margins[:, ORACLE_PRIMED:].numpy()
    bad = [(int(r), int(p) + ORACLE_PRIMED, float(margins[r, p])) for r, p in differ
           if margins[r, p] > ORACLE_MARGIN]
    print(f"check oracle: {sampled} sampled positions x {CLI_IMAGES} rows in {oracle_s:.1f} s, "
          f"flash_attention_fwd launches {launches['oracle_flash_attention_fwd']}; "
          f"cached vs uncached logits at image position {probe}: max_abs_err {logit_diff:.3e}; "
          f"(row, position, margin) that differ: "
          + json.dumps([(int(r), int(p) + ORACLE_PRIMED, round(float(margins[r, p]), 4))
                        for r, p in differ])
          + f"; smallest margin {float(np.nanmin(margins)):.4f}, ORACLE_MARGIN {ORACLE_MARGIN}")
    if launches["oracle_flash_attention_fwd"] != LAYERS * sampled:
        fail(f"the oracle launched flash_attention_fwd {launches['oracle_flash_attention_fwd']} "
             f"times, expected {LAYERS * sampled}")
    if not 2 * logit_diff < ORACLE_MARGIN:
        fail(f"cached and uncached logits differ by {logit_diff:.3e}: ORACLE_MARGIN "
             f"{ORACLE_MARGIN} does not cover twice that")
    if bad:
        fail(f"the oracle's tokens differ from the cached run's above the margin: {bad}")
    dalle_path.unlink()
    clip_path.unlink()
    return launches, walls


# phase 10: mid-decode resume and decode-state migration at flagship width
DRAIN_AT = 512  # every row passes this image position before the drain
ADMIT_AFTER = 8  # chunks the first two requests run before the other two are admitted
PREVIEW_EVERY = 32  # request-level chunks between the streamed request's previews
# the resumed rows' pending logits against the draining engine's at the
# drain: half of ORACLE_MARGIN, so a token whose noised-score margin passes
# ORACLE_MARGIN is drawn alike from either
RESUME_LOGIT_TOL = ORACLE_MARGIN / 2
# the resumed K/V of the positions below each row's k against the
# draining engine's, per layer and row: ||err|| / ||ref||
RESUME_KV_TOL = 2e-2


def kv_rows(torch, engine, slots):
    """[(k, v) per layer] of the engine's cache rows `slots` as fp32
    copies [len(slots), H, total_seq_len + 1, D]: dequantized where the
    cache is int8, gathered through the page table on a paged engine."""
    from dalle_pytorch_tpu_torch.models.attention import _kv_dequantize
    from dalle_pytorch_tpu_torch.ops.flash_decode import paged_gather

    slots = [int(s) for s in slots]
    length = engine.model.total_seq_len + 1
    table = None
    if hasattr(engine, "kv"):
        table = torch.tensor(engine.kv.table[slots], dtype=torch.int32, device=engine.device)
    out = []
    for i in range(engine.model.depth):
        attn = engine._state["cache"][f"layer_{i}"]["attn"]

        def rows(name):
            t = attn[name]
            return paged_gather(t, table, length) if table is not None else t[slots]

        k, v = rows("k"), rows("v")
        if "k_scale" in attn:
            k, v = _kv_dequantize(k, rows("k_scale")), _kv_dequantize(v, rows("v_scale"))
        out.append((k.float().clone(), v.float().clone()))
    return out


def noised_margins(torch, model, specs, tokens):
    """[R, image_seq_len] top-2 gaps of the noised sampling scores along an
    uninterrupted run's tokens, from one teacher-forced uncached forward:
    at each position the engine's keep count, temperature and (seed,
    position) noise."""
    import numpy as np

    from dalle_pytorch_tpu_torch.models.dalle import NEG_MASK_VALUE
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise, keep_count, top_k_filter_per_row

    dev = model.text_emb.weight.device
    text = torch.tensor(np.stack([s.text_ids for s in specs]), device=dev)
    seeds = [int(s.seed) & 0x7FFFFFFF for s in specs]
    temps = torch.tensor([float(s.temperature) for s in specs], device=dev).clamp(min=1e-4)[:, None]
    keep = [keep_count(min(max(float(s.top_k), 0.0), 1.0), model.total_tokens) for s in specs]
    keep_t = torch.tensor(keep, dtype=torch.int32, device=dev)
    blocked = (torch.arange(model.total_tokens, device=dev) < model.total_text_tokens)[None]
    margins = torch.zeros(tokens.shape, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        _, out = model.trunk(text, torch.tensor(tokens, device=dev))
        for p in range(model.image_seq_len):
            row = model.to_logits(out[:, model.text_seq_len + p]).float().masked_fill(blocked, NEG_MASK_VALUE)
            scores = top_k_filter_per_row(row, keep_t, k_max=max(keep)) / temps
            top2 = torch.topk(scores + gumbel_noise(seeds, p, model.total_tokens, dev), 2, dim=-1).values
            margins[:, p] = top2[:, 0] - top2[:, 1]
    return margins.cpu().numpy()


def check_stream(events, first_chunk, terminal, shape):
    """A stream's events: progress chunks strictly rising from above
    `first_chunk`, previews at PREVIEW_EVERY multiples of `shape` ([rows,
    H, W, 3]) in [0, 1], and one `terminal` event, the last. Returns (in
    order, progress chunks, preview chunks)."""
    kinds = [t for _, t, _ in events]
    progress = [d["chunk"] for _, t, d in events if t == "progress"]
    previews = [d for _, t, d in events if t == "preview"]
    ok = (
        progress and progress[0] > first_chunk
        and all(a < b for a, b in zip(progress, progress[1:]))
        and kinds.count(terminal) == 1 and kinds[-1] == terminal
        and sum(kinds.count(t) for t in ("result", "error", "migrated")) == 1
        and all(d["chunk"] % PREVIEW_EVERY == 0 for d in previews)
        and all(d["pixels"].shape == shape and 0.0 <= float(d["pixels"].min())
                and float(d["pixels"].max()) <= 1.0 for d in previews)
    )
    return ok, progress, [d["chunk"] for d in previews]


def drain_at_fixed_chunks(engine, batcher, specs, stream, label):
    """Phase 10's drain schedule: `batcher` (over `engine`) takes the four
    single-row requests of `specs` (request 0 streamed to `stream`),
    requests 0-1 in one admission wave and 2-3 once ADMIT_AFTER chunks
    have run, and `migrate_out` exports them at the first chunk boundary
    at which every row has passed DRAIN_AT. The worker is parked at both
    points until the main thread has acted, so the positions do not
    depend on host timing. Returns (requests, checkpoints, export wall s)."""
    step, chunks_run = engine.step_chunk, [0]
    at_admit, admit_go, at_drain, drain_go = (threading.Event() for _ in range(4))

    def parking_step():
        pos, act = step()
        chunks_run[0] += 1
        if chunks_run[0] == ADMIT_AFTER:
            at_admit.set()
            admit_go.wait(600)
        elif not at_drain.is_set() and act.sum() == 4 and pos[act].min() >= DRAIN_AT:
            at_drain.set()
            drain_go.wait(600)
        return pos, act

    engine.step_chunk = parking_step
    with batcher._cond:  # the worker admits requests 0 and 1 in one wave
        reqs = [batcher.submit([specs[0]], request_key="r0", stream=stream),
                batcher.submit([specs[1]], request_key="r1")]
    if not at_admit.wait(600):
        fail(f"{label}: the first two requests never ran {ADMIT_AFTER} chunks")
    reqs += [batcher.submit([sp], request_key=f"r{i}") for i, sp in enumerate(specs[2:], 2)]
    admit_go.set()
    if not at_drain.wait(600) or any(r.future.done() for r in reqs):
        fail(f"{label}: the rows never all passed position {DRAIN_AT}")
    # the export, asked for while the worker is parked, is served at this boundary
    t_export = time.perf_counter()
    export = {}
    exporter = threading.Thread(target=lambda: export.update(cps=batcher.migrate_out(timeout_s=120)))
    exporter.start()
    while batcher._migrate_request is None and exporter.is_alive():
        time.sleep(0.001)
    drain_go.set()
    exporter.join(150)
    return reqs, export.get("cps"), time.perf_counter() - t_export


def serve_migrated(torch, model, vae, specs, reference, label, paged=False, **options):
    """Phase 10, one layout: a warmed engine with resume and previews
    behind the ContinuousBatcher serves phase 7's four requests and
    exports them under `drain_at_fixed_chunks`' schedule, the checkpoints go
    through encode -> to_wire -> from_wire -> validate (decode), and a
    fresh engine over the same weights (equal fingerprint) resumes them.
    Held: tokens against `reference` (the uninterrupted run) under the
    margin rule, the resumed logits and K/V against the draining
    engine's, launches counted exactly, the decoded-token counter, the
    streams, `leak_check()`; one post-resume chunk under sync-debug
    "error". Returns a summary (the resumed engine under "engine")."""
    import warnings

    import numpy as np

    from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd
    from dalle_pytorch_tpu_torch.serving.batcher import ContinuousBatcher
    from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, PagedContinuousEngine
    from dalle_pytorch_tpu_torch.serving.migrate import MigratedError, encode_checkpoint, from_wire, to_wire
    from dalle_pytorch_tpu_torch.serving.streaming import RequestStream

    cls = PagedContinuousEngine if paged else ContinuousEngine
    if paged:
        options = dict(options, page_size=PAGE)
    depth = model.depth
    int8 = options.get("kv_dtype") == "int8"
    text_len, seq = model.text_seq_len + 1, model.image_seq_len
    device = model.text_emb.weight.device
    image = (1, vae.image_size, vae.image_size, 3)

    def engine():
        eng = cls(model, vae, **CONTINUOUS, tokenizer=ByteTokenizer(), device=device,
                  resume_enabled=True, preview_enabled=True, **options)
        eng.warmup()
        return eng

    # --- the draining engine, up to the drain
    t0 = time.perf_counter()
    eng_a = engine()
    drained = {}
    release = eng_a.release

    def capturing_release(slots):  # the migration's release: state at the drain
        if not drained:
            torch.cuda.synchronize()
            slots = [int(s) for s in slots]
            seeds = [int(batcher_a._inflight[s][0].specs[batcher_a._inflight[s][1]].seed) for s in slots]
            drained.update(
                seeds=seeds, pos=[int(eng_a._state["host"]["img_pos"][s]) for s in slots],
                row=eng_a._state["row"][slots].float().clone(), kv=kv_rows(torch, eng_a, slots),
            )
        release(slots)

    eng_a.release = capturing_release
    batcher_a = ContinuousBatcher(eng_a, preview_every=PREVIEW_EVERY)
    stream_a = RequestStream(key="r0")
    reqs, cps, export_s = drain_at_fixed_chunks(eng_a, batcher_a, specs, stream_a, label)
    batcher_a.shutdown()
    for req in reqs:
        try:
            req.future.result(0)
            fail(f"{label}: a request finished instead of migrating")
        except MigratedError:
            pass
    leaks_a = eng_a.kv.leak_check() if paged else []
    fingerprint = eng_a.resume_fingerprint()
    chunks_a = eng_a.stats.chunks
    del eng_a, batcher_a
    drain_s = time.perf_counter() - t0
    if cps is None or len(cps) != 4 or sorted(cp.request_key for cp in cps) != ["r0", "r1", "r2", "r3"]:
        fail(f"{label}: migrate_out gave {cps}")
    cps = sorted(cps, key=lambda cp: cp.request_key)
    ks = [cp.rows[0].pos for cp in cps]

    # --- the wire: encode once, ship, decode and validate on the new engine
    t_enc = time.perf_counter()
    wires = [to_wire(encode_checkpoint(cp, fingerprint)) for cp in cps]
    encode_s = time.perf_counter() - t_enc
    eng_b = engine()
    if eng_b.resume_fingerprint() != fingerprint:
        fail(f"{label}: the resuming engine's fingerprint differs from the draining engine's")
    counters = {name: (getattr(fd, fn), attr) for name, (fn, attr) in DECODE_COUNTERS.items()}
    resume_kernel = "flash_decode_int8" if int8 else "flash_decode"
    step_kernel = ("paged_flash_decode" if paged else "flash_decode") + ("_int8" if int8 else "")
    resumed = {}
    resume_slots = eng_b.resume_slots

    def timed_resume(assignments):  # the resume dispatch: its wall, launches and state
        fn, attr = counters[resume_kernel]
        before, tile_before = getattr(fn, attr), getattr(fn, "tile_" + attr)
        torch.cuda.synchronize()
        t = time.perf_counter()
        resume_slots(assignments)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        slots = [int(s) for s, _ in assignments]
        resumed.setdefault("walls", []).append(wall)
        resumed.setdefault("launches", []).append(getattr(fn, attr) - before)
        resumed.setdefault("tile_launches", []).append(getattr(fn, "tile_" + attr) - tile_before)
        resumed.update(seeds=[int(sp.seed) for _, sp in assignments],
                       row=eng_b._state["row"][slots].float().clone(), kv=kv_rows(torch, eng_b, slots))

    eng_b.resume_slots = timed_resume
    batcher_b = ContinuousBatcher(eng_b, preview_every=PREVIEW_EVERY)
    t_dec = time.perf_counter()
    valid = [batcher_b.validate_resume(w, [sp]) for w, sp in zip(wires, specs)]
    decode_s = time.perf_counter() - t_dec
    if any(cp is None for cp, _ in valid):
        fail(f"{label}: a checkpoint did not validate on the resuming engine")
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    stream_b = RequestStream(key="r0")
    t_run = time.perf_counter()
    reqs = [batcher_b.submit([sp], request_key=f"r{i}", resume=cp, resume_bytes=size,
                             stream=stream_b if i == 0 else None)
            for i, (sp, (cp, size)) in enumerate(zip(specs, valid))]
    outs = [r.future.result(timeout=900) for r in reqs]
    resume_run_s = time.perf_counter() - t_run
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    batcher_b.shutdown()
    toks = np.concatenate([o[0] for o in outs])
    pixels = np.concatenate([o[1] for o in outs])

    # --- tokens under the margin rule
    margins = noised_margins(torch, model, specs, reference)
    equal, first_low, first_diff = [], [], []
    for r, k in enumerate(ks):
        low = np.flatnonzero(margins[r, k:] < ORACLE_MARGIN)
        diff = np.flatnonzero(toks[r] != reference[r])
        first_low.append(int(k + low[0]) if low.size else None)
        first_diff.append(int(diff[0]) if diff.size else None)
        equal.append(int((toks[r] == reference[r]).sum()))
    # --- logits and K/V of the resumed rows against the drain
    order = [resumed["seeds"].index(sd) for sd in drained["seeds"]]
    logit_err = (resumed["row"][order] - drained["row"]).abs().amax(dim=-1).tolist()
    kv_err, kv_max = 0.0, 0.0
    for (ka, va), (kb, vb) in zip(drained["kv"], resumed["kv"]):
        for r, (slot_b, k) in enumerate(zip(order, drained["pos"])):
            for a, b_ in ((ka[r], kb[slot_b]), (va[r], vb[slot_b])):
                a, b_ = a[:, : text_len + k], b_[:, : text_len + k]
                kv_err = max(kv_err, ((b_ - a).norm() / a.norm().clamp(min=1e-30)).item())
                kv_max = max(kv_max, (b_ - a).abs().max().item())
    decoded = int(batcher_b.registry.get("dalle_serving_decoded_tokens_total").value)
    restored = int(batcher_b.registry.get("dalle_serving_resumed_tokens_total").value)
    chunks, dispatches = eng_b.stats.chunks, eng_b.stats.resume_dispatches
    expected = {step_kernel: depth * CONTINUOUS["chunk_tokens"] * chunks}
    expected[resume_kernel] = expected.get(resume_kernel, 0) + depth * dispatches
    others = {k: n for k, n in launches.items() if n and k not in expected}
    ok_a, prog_a, prev_a = check_stream(stream_a.next_events(0, 0.0)[0], -1, "migrated", image)
    ok_b, prog_b, prev_b = check_stream(stream_b.next_events(0, 0.0)[0], prog_a[-1] if prog_a else -1,
                                        "result", image)
    summary = dict(
        run=label, drain_at=ks, chunks_before_drain=chunks_a, chunks_after=chunks,
        drain_s=drain_s, export_s=export_s, encode_s=encode_s, decode_s=decode_s,
        checkpoint_bytes=[size for _, size in valid], resume_run_s=resume_run_s,
        resume_dispatch_walls_s=resumed["walls"], resume_dispatches=dispatches,
        resume_launches=resumed["launches"], resume_tile_launches=resumed["tile_launches"],
        launches={k: n for k, n in launches.items() if n},
        expected_launches=expected, decoded_tokens=decoded, resumed_tokens=restored,
        logit_max_abs_err=logit_err, logit_tol=RESUME_LOGIT_TOL, kv_rel_err=kv_err,
        kv_max_abs_err=kv_max, kv_tol=RESUME_KV_TOL, equal_tokens=equal, first_sub_margin=first_low,
        first_divergence=first_diff, stream_a=dict(progress=prog_a[:3] + prog_a[-2:], previews=prev_a),
        stream_b=dict(progress=prog_b[:3] + prog_b[-2:], previews=prev_b),
    )
    print("migrated " + json.dumps(summary))
    if toks.shape != (4, seq) or pixels.shape != (4,) + image[1:] or not np.isfinite(pixels).all():
        fail(f"{label}: tokens {toks.shape} or pixels {pixels.shape} wrong")
    for r in range(4):
        if first_diff[r] is not None and (first_low[r] is None or first_diff[r] < first_low[r]):
            fail(f"{label}: row {r} diverged from the uninterrupted run at {first_diff[r]}, before "
                 f"its first sub-margin position {first_low[r]}")
        if first_diff[r] is not None and first_diff[r] < ks[r]:
            fail(f"{label}: row {r} lost its restored prefix")
    if max(logit_err) > RESUME_LOGIT_TOL or kv_err > RESUME_KV_TOL:
        fail(f"{label}: resumed logits {logit_err} or K/V {kv_err} over tolerance")
    if resumed["launches"] != [depth] * dispatches or dispatches != 1:
        fail(f"{label}: resume dispatches {dispatches} launched {resumed['launches']}")
    if resumed["tile_launches"] != [depth] * dispatches:  # n = 1280, bf16 q: the tile arm
        fail(f"{label}: resume dispatches launched the tile arm {resumed['tile_launches']} times")
    if any(launches[k] != n for k, n in expected.items()) or others:
        fail(f"{label}: launches {launches}, expected {expected}")
    if decoded != sum(seq - k for k in ks) or restored != sum(ks):
        fail(f"{label}: decoded {decoded}, restored {restored} for resume positions {ks}")
    if not (ok_a and ok_b):
        fail(f"{label}: stream events out of order: {prog_a} {prev_a} / {prog_b} {prev_b}")
    if not np.array_equal(stream_b.next_events(0, 0.0)[0][-1][2]["tokens"], toks[:1]):
        fail(f"{label}: the stream's result tokens differ from the request's")
    if paged and (leaks_a or eng_b.kv.leak_check()):
        fail(f"{label}: leak_check {leaks_a} / {eng_b.kv.leak_check()}")

    # one resume, then a chunk under sync-debug "error": no host sync
    spec0 = reqs[0].specs[0]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            resume_slots([(0, spec0)])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    resume_syncs = [str(w.message).splitlines()[0][:160] for w in caught if "synchroniz" in str(w.message)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng_b.dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pos, act = eng_b.chunk_snapshot()
    eng_b.release([0])
    print(f"check migrated {label}: a chunk after a resume under sync-debug mode 'error': no host "
          f"sync (slot 0 from {spec0.resume_pos} to {pos[0]}); the resume dispatch itself warned of "
          f"{len(resume_syncs)} synchronizing calls {resume_syncs}")
    if pos[0] != spec0.resume_pos + CONTINUOUS["chunk_tokens"] or not act[0]:
        fail(f"{label}: the sync-debug chunk left slot 0 at {pos[0]}")
    if paged and eng_b.kv.leak_check():
        fail(f"{label}: leak_check after the sync-debug chunk {eng_b.kv.leak_check()}")
    # the resume dispatch's device time, after the last timed phase
    wave = [(s, r.specs[0]) for s, r in enumerate(reqs)]
    summary["resume_dispatch_ms"] = 1e3 * float(np.median(resumed["walls"]))

    def one_resume():
        resume_slots(wave)
        eng_b.release(range(4))

    one_resume.__name__ = f"resume_slots ({label})"
    defer_device_time(summary, one_resume, [()], 3, prefix="resume_dispatch_")
    summary.update(engine=eng_b, launches_total=launches)
    return summary


def run_migration(torch, model, vae, specs, causal_tokens, int8_tokens):
    """Phase 10: the slotted and the paged (kernel impl) engines at
    flagship width, then int8 KV on phase 7's depth-4 model. Returns the
    three summaries."""
    slotted = serve_migrated(torch, model, vae, specs, causal_tokens, "slotted causal")
    paged = serve_migrated(torch, model, vae, specs, causal_tokens, "paged kernel causal", paged=True,
                           paged_decode_impl="kernel")
    short = first_layers(torch, model, SHORT_DEPTH)
    int8 = serve_migrated(torch, short, vae, specs, int8_tokens, f"slotted int8 depth {SHORT_DEPTH}",
                          kv_dtype="int8")
    return slotted, paged, int8


def resume_fields(row, err, runs):
    """The resume-shape entries of a kernel's line: phase 3's times at n =
    1280 and phase 10's launches per resume dispatch and resume walls."""
    out = {f"resume_{k}": v for k, v in row.items() if k != "device_kernels" and not k.endswith("_device_kernels")}
    out["resume_max_abs_err"] = err
    out["resume_launches"] = {r["run"]: r["resume_launches"] for r in runs}
    out["resume_tile_launches"] = {r["run"]: r["resume_tile_launches"] for r in runs}
    out["resume_dispatch_ms"] = {r["run"]: r["resume_dispatch_ms"] for r in runs}
    out["resume_dispatch_device_ms"] = {r["run"]: r.get("resume_dispatch_device_ms") for r in runs}
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
    kernels.build(["flash_decode", "flash_decode_tile", "flash_decode_tile_f32", "flash_attention",
                   "wide_head", "wide_decode_tile"])
    print(f"build: {time.perf_counter() - t0:.2f} s total")
    for name, info in kernels.build_log.items():
        print(f"build {name}: {info['seconds']:.2f} s -> {info['path']}")
        entry = ""
        for line in info["ptxas"].splitlines():
            compiling = re.search(r"Compiling entry function '([^']+)'", line)
            if compiling:  # a mangled name: show the kernel and its first int parameter
                entry = mangled_kernel(compiling.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {entry}: {line.strip()}")
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if (name.startswith("flash_decode_tile") and spills
                        and spills.group(0) != "0 bytes spill stores, 0 bytes spill loads"):
                    fail(f"a {name} instance spills: {line.strip()}")
    wide_build = check_wide_build(kernels.build_log["wide_head"])
    print("wide_head kernels (ptxas, cuobjdump -sass): " + json.dumps(wide_build))
    tile_build = check_wide_tile_build(kernels.build_log["wide_decode_tile"])
    print("wide_decode_tile instances (ptxas, cuobjdump -sass): " + json.dumps(tile_build))
    tf32_build = check_tf32_build(kernels.build_log["flash_attention"])
    print("flash_attention fp32 backward passes (ptxas, cuobjdump -sass): " + json.dumps(tf32_build))

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
    wide_decode_errs, _ = check_wide_decode(torch)
    wide_attn_errs = check_wide_attention(torch)
    print(f"phase 2 wide head-dim checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    variant_errs = check_decode_variants(torch, cases)
    print(f"phase 2 int8 and block-sparse checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paged_errs, _ = check_paged_variants(torch)
    print(f"phase 2 paged checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attn_errs = check_attention(torch)
    print(f"phase 2 flash_attention checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tile_errs = check_tile_arm(torch, cases)
    print(f"phase 2 tile-arm and resume-shape checks: {time.perf_counter() - t0:.1f} s")

    # 3. times ---------------------------------------------------------------
    timings = {}
    for dtype, key, elt in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4)):
        for case in ("prefill", "step"):
            timings[(case, key)] = time_decode(torch, peaks, dtype, key, elt, case, *cases[case])
    step = timings[("step", "bf16")]
    est = LAYERS * (timings[("prefill", "bf16")]["ms"] + 1024 * step["ms"])
    print(f"flash_decode per main-path batch (bf16, from the timed shapes): ~{est:.1f} ms")
    variant_times = time_decode_variants(torch, F, peaks, smi, cases)
    tile_times = time_tile_arm(torch, F, peaks, smi, cases)
    tile_f32_times = time_tile_f32_arm(torch, F, peaks, smi, cases)
    tile_variant_times = time_tile_variants(torch, F, peaks, smi)
    paged_times = time_paged_variants(torch, F, peaks, smi, cases)
    attn_times = time_attention(torch, F, peaks, torch.bfloat16, "bf16", 2)
    attn_fp32 = time_attention(torch, F, peaks, torch.float32, "fp32", 4)
    # the largest head dim the kernels take (the 256 instances: bf16 backward
    # in two column halves, fp32 dq / dk-dv with K and V sharing a buffer)
    attn_d256 = {key: time_attention(torch, F, peaks, dt, key, elt, d=256)
                 for dt, key, elt in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4))}
    t0 = time.perf_counter()
    wide_times = time_wide_kernels(torch, F, peaks, smi)
    print(f"phase 3 wide head-dim times: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_tile_variants = {d: time_tile_variants(torch, F, peaks, smi, d=d) for d in WIDE_TIMED_DIMS}
    print(f"phase 3 wide tile kernel's kernels 3-5 at D={WIDE_TIMED_DIMS}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_f32_variants = {d: time_tile_variants(torch, F, peaks, smi, d=d, dtype=torch.float32)
                         for d in WIDE_TIMED_DIMS}
    print(f"phase 3 fp32 multi-row kernel's kernels 2-5 at D={WIDE_TIMED_DIMS}: {time.perf_counter() - t0:.1f} s")

    # 4. model on the card: kernel path vs dense path ----------------------
    # the fp32 model's prefill and resume (n > 4) run the fp32 tile arm
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    for f in DECODE_FUNCTIONS:
        getattr(fd, f).tile_f32_launches = getattr(fd, f).tile_f32_int8_launches = 0
    check_small_model_decode(torch, 64)
    f32_launches = tile_launches("tile_f32")
    print(f"phase 4 fp32 model (dim_head 64): fp32 tile arm launches {f32_launches} (prefill + resume)")
    if f32_launches == 0:
        fail("the fp32 model's prefill and resume did not launch the fp32 tile arm")
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    before = fa.flash_attention_bwd.launches
    check_small_model_training(torch, 64)
    small_bwd = fa.flash_attention_bwd.launches - before
    print(f"phase 4 fp32 model (dim_head 64): fp32 backward calls {small_bwd} (each the TF32 passes "
          f"{list(fa.attention_kernels(64, torch.float32)['bwd'])}; a trace names them after phase 10)")
    if small_bwd != FP32_TRAINING_BWD:
        fail(f"the fp32 training run called the fp32 backward {small_bwd} times, expected {FP32_TRAINING_BWD}")
    # the same at a head dim above 256: the wide kernels on the model's path
    from dalle_pytorch_tpu_torch.ops import wide_head as wh

    wide_counters = (wh.wide_decode, wh.wide_attention_fwd, wh.wide_attention_bwd)
    for c in wide_counters:
        c.launches = 0
    for c in wide_counters[1:]:
        c.mma_launches = 0
    wh.wide_decode.split_launches = wh.wide_decode.tile_launches = wh.wide_decode.tile_f32_launches = 0

    def decode_counts():
        """(all, split-K, tile, fp32 multi-row) wide decode launches so far."""
        d = wh.wide_decode
        return (d.launches, d.split_launches, d.tile_launches, d.tile_f32_launches)

    # the small model (depth 2): each run's prefill and resume are one
    # multi-row call a layer (4), its 64 steps one split-K call a layer (128)
    check_small_model_decode(torch, WIDE_IDENTITY_DIM)
    fp32_counts = decode_counts()
    check_small_model_decode(torch, WIDE_IDENTITY_DIM, torch.bfloat16)
    bf16_counts = tuple(a - b for a, b in zip(decode_counts(), fp32_counts))
    print(f"phase 4 at dim_head {WIDE_IDENTITY_DIM}: wide decode launches (all, split-K, tile, fp32 "
          f"multi-row) of the fp32 run {fp32_counts}, of the bf16 run {bf16_counts}")
    if fp32_counts != (132, 128, 0, 4) or bf16_counts != (132, 128, 4, 0):
        fail(f"the dim_head {WIDE_IDENTITY_DIM} model's decode launches: fp32 {fp32_counts}, bf16 "
             f"{bf16_counts}, expected (132, 128, 0, 4) and (132, 128, 4, 0)")
    fwd, bwd = wh.wide_attention_fwd, wh.wide_attention_bwd
    before = (fwd.launches - fwd.mma_launches, bwd.launches - bwd.mma_launches)
    check_small_model_training(torch, WIDE_IDENTITY_DIM)
    fp32_fwd = fwd.launches - fwd.mma_launches - before[0]
    fp32_bwd = bwd.launches - bwd.mma_launches - before[1]
    print(f"phase 4 at dim_head {WIDE_IDENTITY_DIM}: fp32 forward calls of the fp32 training run "
          f"{fp32_fwd} ({wh.wide_attention_kernels(WIDE_IDENTITY_DIM, torch.float32)['fwd']}), backward "
          f"calls {fp32_bwd} (each the two passes "
          f"{list(wh.wide_attention_kernels(WIDE_IDENTITY_DIM, torch.float32)['bwd'])})")
    if (fp32_fwd, fp32_bwd) != (FP32_TRAINING_FWD, FP32_TRAINING_BWD):
        fail(f"the dim_head {WIDE_IDENTITY_DIM} fp32 training run called the fp32 forward {fp32_fwd} and "
             f"backward {fp32_bwd} times, expected {FP32_TRAINING_FWD} and {FP32_TRAINING_BWD}")
    check_small_model_training(torch, WIDE_IDENTITY_DIM, torch.bfloat16)
    wide_launches = {c.__name__: c.launches for c in wide_counters[1:]}
    wide_launches.update({f"{c.__name__}_mma": c.mma_launches for c in wide_counters[1:]})
    wide_launches.update(wide_split=fp32_counts[1] + bf16_counts[1], wide_tile=bf16_counts[2],
                         wide_tile_f32=fp32_counts[3])
    print(f"phase 4 at dim_head {WIDE_IDENTITY_DIM}: wide kernel launches (wide_split: the split-K "
          f"steps, wide_tile: the bf16 prefill and resume, wide_tile_f32: the fp32 ones; _mma: the bf16 "
          f"tensor-core kernels, in the bf16 autocast run) {json.dumps(wide_launches)}")
    for name, count in wide_launches.items():
        if count == 0:
            fail(f"{name} was not launched by the dim_head {WIDE_IDENTITY_DIM} model")

    # 5. generation path -------------------------------------------------------
    engine, specs, n_params = flagship_engine()
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    flash_decode_attention.launches = 0
    flash_decode_attention.tile_launches = 0
    t0 = time.perf_counter()
    toks, pixels = engine.generate(specs)
    wall = time.perf_counter() - t0
    launches = {"flash_decode": flash_decode_attention.launches,
                "flash_decode_tile": flash_decode_attention.tile_launches}
    expected = LAYERS * (1 + engine.image_seq_len)
    print(
        f"main path: {n_params / 1e6:.1f} M DALLE params bf16, warmup {warm_s:.2f} s, "
        f"generate {wall:.3f} s for 4 images = {4 / wall:.3f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}"
    )
    if launches["flash_decode"] != expected:
        fail(f"flash_decode launched {launches['flash_decode']} times, expected {expected}")
    if launches["flash_decode_tile"] != LAYERS:  # the prefill, one call a layer
        fail(f"the prefill launched the tile arm {launches['flash_decode_tile']} times, expected {LAYERS}")
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
    t0 = time.perf_counter()
    fp32_train = run_fp32_training(torch)
    print(f"phase 6b fp32 training: {time.perf_counter() - t0:.1f} s")

    # 7. continuous-serving path ---------------------------------------------------
    t0 = time.perf_counter()
    continuous_launches, causal_toks, patterned, patterned_toks, (short_toks, int8_toks) = (
        run_continuous(torch, model5, vae, specs, toks))
    launches.update(continuous_launches)
    print(f"phase 7 continuous serving: {time.perf_counter() - t0:.1f} s")

    # 8. paged continuous serving with a prefix cache ---------------------------------
    t0 = time.perf_counter()
    launches.update(run_paged(torch, model5, patterned, vae, specs, causal_toks, patterned_toks,
                              short_toks))
    print(f"phase 8 paged serving: {time.perf_counter() - t0:.1f} s")

    # 9. the generation CLI end to end ----------------------------------------------
    t0 = time.perf_counter()
    cli_launches, _ = run_generation_cli(torch, vae)
    print(f"phase 9 generation CLI: {time.perf_counter() - t0:.1f} s")

    # 10. mid-decode resume and migration -------------------------------------------
    t0 = time.perf_counter()
    migrated = run_migration(torch, model5, vae, specs, causal_toks, int8_toks)
    print(f"phase 10 resume and migration: {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s after the build started")

    # device time per call of phase 3's kernel rows, and the kernel the
    # forward's row ran, from traces made after every timed phase: a
    # torch.profiler trace leaves the CUDA tracer attached, which slows
    # each launch after it
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    t_traces = time.perf_counter()
    for row, fn, inputs, iters, prefix in DEVICE_ROWS:
        t0 = time.perf_counter()
        ms, kernels_called = device_ms(torch, fn, inputs, iters)
        row[prefix + "device_ms"], row[prefix + "device_kernels"] = ms, kernels_called
        label = fn.__name__ + (f" ({prefix.rstrip('_')})" if prefix else "")
        print(f"device time {label}: {ms:.5f} ms a call (event time {row[prefix + 'ms']:.5f}), "
              f"kernels a call {json.dumps(kernels_called)} ({time.perf_counter() - t0:.1f} s)")
    print(f"device times of phase 3's {len(DEVICE_ROWS)} rows: {time.perf_counter() - t_traces:.1f} s")
    DEVICE_ROWS.clear()

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, h, n, d = TRAIN["batch"], TRAIN["heads"], TRAIN["n"], TRAIN["dim_head"]
    qkv = [torch.randn(b, h, n, d, generator=g, device="cuda").bfloat16() for _ in range(3)]
    traced = launched_kernel(torch, fa.flash_attention_fwd, qkv)
    attn_times["flash_attention_fwd"]["cuda_kernel"] = traced
    for name, row in attn_times.items():
        for key, rows in attn_d256.items():
            for field in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms"):
                if field in rows[name]:
                    row[f"d256_{key}_{field}"] = rows[name][field]
        for field in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                      "bound_by"):
            row[f"fp32_{field}"] = attn_fp32[name][field]
    # the wide rows' traces name the kernels the routing rule names, and
    # the kernels SDPA ran beside them
    for d in WIDE_TIMED_DIMS:
        for key in ("bf16", "fp32"):
            named = fa.attention_kernels(d, wide_dtype(torch, key))
            for pass_, want in (("fwd", [named["fwd"]]), ("bwd", list(named["bwd"]))):
                row = wide_times[f"wide_attention_{pass_}"][(d, key, "train")]
                seen = row.get("device_kernels", {})
                if any(k not in seen for k in want):
                    fail(f"wide attention {pass_} {key} at D = {d}: the trace shows {list(seen)}, the "
                         f"routing {want}")
                row["library_cuda_kernel"] = " + ".join(row.get("library_device_kernels", {}))
                print(f"phase 3 at D = {d} {key}: SDPA's {pass_} ran {row['library_cuda_kernel']}")
        for arm, key, kernel in (("wide_tile", "bf16", "wide_decode_tile_kernel<"),
                                 ("wide_tile_f32", "fp32", "wide_decode_fma_kernel<")):
            for shape in WIDE_SHAPES:
                seen = wide_times[arm][(d, key, shape)].get("device_kernels", {})
                if not any(k.startswith(kernel) for k in seen):
                    fail(f"the {key} {shape} at D = {d}: the trace shows {list(seen)}, not {kernel}>")
    print(f"phase 3's bf16 forward launches {traced} (torch.profiler trace of one call)")
    # phases 4 and 6b's fp32 backward: a trace of one call names the kernels attention_kernels names
    small = [torch.randn(2, 2, 80, 64, generator=g, device="cuda") for _ in range(4)]
    o, lse = fa.flash_attention_fwd(*small[:3])
    _, seen = device_ms(torch, fa.flash_attention_bwd,
                        [(*small, lse, (small[3] * o).sum(-1))], 1)
    named = fa.attention_kernels(64, torch.float32)["bwd"]
    print(f"phase 4 and 6b's fp32 backward launches {json.dumps(seen)} (torch.profiler trace of one call)")
    if sorted(seen) != sorted(named):
        fail(f"the fp32 backward's trace shows {list(seen)}, attention_kernels names {list(named)}")
    for d, rows in ((64, attn_fp32), (256, attn_d256["fp32"])):  # the fp32 forward's traces
        seen, want = rows["flash_attention_fwd"]["device_kernels"], fa.attention_kernels(d, torch.float32)["fwd"]
        if want not in seen:
            fail(f"the fp32 forward at D = {d}: the trace shows {list(seen)}, attention_kernels names {want}")
    for name, row in attn_times.items():
        print(f"phase 3 {name} fp32 device ms (kernel / SDPA): D=64 {row['fp32_device_ms']:.4f} / "
              f"{row['fp32_library_device_ms']:.4f}, D=256 {row['d256_fp32_device_ms']:.4f} / "
              f"{row['d256_fp32_library_device_ms']:.4f}; kernels a call "
              f"{json.dumps(attn_fp32[name]['device_kernels'])}")
    for key in ("bf16", "fp32"):
        row = timings[("step", key)]
        print(f"phase 3 flash_decode step {key} device ms {row['device_ms']:.5f}, SDPA "
              f"{row['library_device_ms']:.5f} ({' + '.join(row['library_device_kernels'])})")
    for (d, key, _), row in wide_times["wide_step"].items():
        seen = row.get("device_kernels", {})
        if not any(k.startswith("wide_split_kernel") for k in seen):
            fail(f"the {key} step at D = {d}: the trace shows {list(seen)}, not wide_split_kernel")
        row["cuda_kernel"] = " + ".join(seen)
        row["library_cuda_kernel"] = " + ".join(row.get("library_device_kernels", {}))
        print(f"phase 3 step at D = {d} {key}: {row['cuda_kernel']} device {row['device_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f}, SDPA {row['library_device_ms']:.4f} ({row['library_cuda_kernel']})")

    # result -------------------------------------------------------------------
    kernels_line = {
        "kernels": [
            dict(
                name="flash_decode",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:76",
                launches=launches["flash_decode"] - launches["flash_decode_tile"],
                max_abs_err=max(e for (c, d), e in errs.items() if d == torch.bfloat16 and c.startswith("step")),
                ms=step["ms"],
                plain_ms=step["plain_ms"],
                device_ms=step["device_ms"],
                device_kernels=step["device_kernels"],
                cli_launches=cli_launches["cli_flash_decode"],
                bound_ms=step["bound_ms"],
                bound_by=step["bound_by"],
                library_ms=step["library_ms"],
                library_device_ms=step["library_device_ms"],
                **{f"fp32_{k}": v for k, v in timings[("step", "fp32")].items() if "kernels" not in k},
                timed="bf16 step n=1 B=4 H=16 D=64 S=1281 lengths [258, 700, 1024, 1281] (fp32_*: "
                "the same step with fp32 q and cache, bound at the fp32 peak); "
                "launches: phase 5's steps (its prefill is the tile arm's); cli_launches: phase "
                "9's generation CLI (2 prompts x one batch of 4, prefill included)",
            ),
            dict(
                name="flash_decode_tile_f32",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode_tile_f32.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:76, :292, :446, :552",
                launches=f32_launches,
                max_abs_err=tile_errs["flash_decode_tile_f32"],
                **tile_f32_times["resume"]["flash_decode_tile_f32"],
                int8_max_abs_err=tile_errs["flash_decode_tile_f32_int8"],
                **{f"int8_{k}": v for k, v in tile_f32_times["resume"]["flash_decode_tile_f32_int8"].items()},
                **{f"prefill_{k}": v for k, v in tile_f32_times["prefill"]["flash_decode_tile_f32"].items()},
                **{f"prefill_int8_{k}": v
                   for k, v in tile_f32_times["prefill"]["flash_decode_tile_f32_int8"].items()},
                timed="fp32 q, resume n=1280 S=1281 B=4 H=16 D=64 lengths 1280 (int8_*: int8 K/V + "
                "fp32 scales; prefill_*: n=257 over the 1281-slot cache, lengths 257); library_ms is "
                "SDPA's causal forward in fp32 over the n live keys (the same function); bounds at "
                "the fp32 peak; launches: phase 4's fp32 model (prefill and resume); max_abs_err: "
                "worst of prefill, prefill_edges, resume B=1 and 4 against the plain version",
            ),
            dict(
                name="flash_decode_tile",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode_tile.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:76, :292, :446, :552",
                launches=launches["flash_decode_tile"],
                max_abs_err=tile_errs["flash_decode_tile"],
                **tile_times["prefill"]["flash_decode_tile"],
                **{f"int8_{k}": v for k, v in tile_times["prefill"]["flash_decode_tile_int8"].items()},
                int8_max_abs_err=tile_errs["flash_decode_tile_int8"],
                **resume_fields(tile_times["resume"]["flash_decode_tile"], tile_errs["flash_decode_tile"],
                                migrated[:2]),
                **{f"int8_{k}": v for k, v in resume_fields(
                    tile_times["resume"]["flash_decode_tile_int8"], tile_errs["flash_decode_tile_int8"],
                    migrated[2:]).items()},
                timed="bf16 q, prefill n=257 B=4 H=16 D=64 S=1281 lengths 257 (int8_*: int8 K/V + "
                "fp32 scales); library_ms is SDPA's causal forward over the 257 live keys (the same "
                "function); launches: phase 5's prefill (one a layer); resume_*: n=1280 S=1281 B=4 "
                "lengths 1280, launches per resume dispatch of phase 10 (slotted, paged; int8_: "
                "the int8 run at depth 4); max_abs_err: worst of prefill, prefill_edges, resume B=1 "
                "and 4 against the plain version",
            ),
        ] + [
            dict(
                name=name,
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
                replaces=f"dalle_pytorch_tpu/ops/pallas_attention.py:{line}",
                launches=launches[name],
                max_abs_err=attn_errs["bf16"][name],
                **attn_times[name],
                **({"oracle_launches": cli_launches["oracle_flash_attention_fwd"]}
                   if name.endswith("fwd") else {}),
                timed="bf16 causal B=4 H=16 N=1280 D=64"
                + ("" if name.endswith("fwd") else "; one fused kernel for dq, dk and dv; "
                   "library_ms is SDPA's whole backward, whole_backward_ms the port's (delta "
                   "+ workspace zeroing + kernel + dq conversion)")
                + "; fp32_*: the same shapes in fp32 (the 3xTF32 tensor-core kernels), bound at three "
                "times the flops at the TF32 peak",
            )
            for name, line in (
                ("flash_attention_fwd", "129"),
                ("flash_attention_bwd", "274, dalle_pytorch_tpu/ops/pallas_attention.py:333"),
            )
        ] + [
            dict(
                name=f"{name}_fp32",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
                replaces=f"dalle_pytorch_tpu/ops/pallas_attention.py:{line}",
                launches=fp32_train["launches"][name],
                max_abs_err=attn_errs["fp32"][name],
                split_model_max_abs_err=attn_errs["fp32"]["split_model" if name.endswith("bwd") else "split_model_fwd"],
                cuda_kernel=" + ".join(kernel if isinstance(kernel, tuple) else (kernel,)),
                **{k: v for k, v in attn_fp32[name].items() if "kernels" not in k},
                **{f"d256_{k}": v for k, v in attn_d256["fp32"][name].items() if "kernels" not in k},
                train_ms_per_step=fp32_train["ms_per_step"],
                timed=f"fp32 causal B=4 H=16 N=1280 D=64 (d256_*: D=256); {what}; launches: phase 6b's "
                f"{FP32_TRAIN_STEPS} fp32 training steps of the flagship (one call a layer a step"
                + (", each the two passes" if name.endswith("bwd") else "") + "); library_ms is SDPA's "
                + ("forward" if name.endswith("fwd") else "whole backward") + " in fp32",
            )
            for name, line, kernel, what in (
                ("flash_attention_fwd", "129", fa.attention_kernels(64, torch.float32)["fwd"],
                 "one pass on tensor cores, every product three TF32 products (bound: three times 4 D "
                 "flops a visible pair at the TF32 peak); max_abs_err against the exact fp32 plain "
                 "version, split_model_max_abs_err against flash_attention_forward_tf32x3_plain (worst "
                 "of phase 2's fp32 cases)"),
                ("flash_attention_bwd", "274, dalle_pytorch_tpu/ops/pallas_attention.py:333",
                 fa.attention_kernels(64, torch.float32)["bwd"],
                 "dq then dk/dv on tensor cores, every product three TF32 products (bound: three times "
                 "10 D flops a visible pair at the TF32 peak); max_abs_err against the exact fp32 plain "
                 "version, split_model_max_abs_err against flash_attention_bwd_tf32x3_plain (worst of "
                 "phase 2's fp32 cases)"),
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
                "[258, 700, 1024, 1281]; launches: phase 7 int8 run's steps (depth 4; its "
                "prefill is the tile arm's); library_ms is SDPA over the bf16 cache",
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
                **{f"tile_resume_{k}": v for k, v in tile_variant_times["block_sparse_flash_decode"].items()
                   if k != "device_kernels"},
                timed="bf16 step n=1 B=4 H=16 D=64 S=1281, axial_row policy bitmap; launches: "
                "phase 7 policy run's steps (bf16 arm, depth 4) + policy+int8 patterned run's "
                "(int8 arm; both runs' prefills are the tile arm's); "
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
                **{f"tile_resume_{k}": v for k, v in tile_variant_times["paged_flash_decode"].items()
                   if k != "device_kernels"},
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
                **{f"tile_resume_{k}": v for k, v in tile_variant_times["block_sparse_paged_flash_decode"].items()
                   if k != "device_kernels"},
                timed="bf16 step as paged_flash_decode, axial_row policy bitmap re-expanded to "
                "pages; launches: phase 8 policy+int8 patterned run (int8 arm); library_ms is "
                "SDPA with the page-expanded mask over the gathered cache",
            ),
        ] + [
            dict(
                name=name,
                route="cuda",
                source=f"dalle_pytorch_tpu_torch/csrc/{source}.cu",
                replaces=replaces,
                launches=wide_launches[name],
                **({"mma_launches": wide_launches[name + "_mma"]} if name + "_mma" in wide_launches else {}),
                max_abs_err=err,
                **wide_fields(wide_times[arm], main_case),
                **extra,
                timed=timed,
            )
            for name, arm, source, main_case, replaces, err, extra, timed in (
                ("wide_split", "wide_split", "wide_head", (WIDE_TIMED_DIMS[0], "bf16", "step"),
                 "dalle_pytorch_tpu/ops/pallas_decode.py:76, :292, :446, :552",
                 wide_decode_errs["wide_split"],
                 {"d%d_%s_%s_%s" % (*case, k): v for case, row in wide_times["wide_step"].items()
                  for k, v in row.items() if "kernels" not in k},
                 f"kernels 1-5 at D > 256 and n <= 4 (split-K, any D); bf16 step n=1 B=4 H=16 S=1281 "
                 f"D={WIDE_TIMED_DIMS[0]} lengths [258, 700, 1024, 1281] (d<D>_<dtype>_step_*: the "
                 f"other D and fp32, fp32 bound at the fp32 peak; d{WIDE_STEP_DIM}_*: the step above "
                 f"1024 channels, the kernel's wide instance (8 chunks of 4 columns a thread), "
                 f"`cuda_kernel`); launches: phase 4's dim_head {WIDE_IDENTITY_DIM} model (its steps, "
                 "fp32 and bf16 runs)"),
                ("wide_tile", "wide_tile", "wide_decode_tile", (WIDE_TIMED_DIMS[0], "bf16", "resume"),
                 "dalle_pytorch_tpu/ops/pallas_decode.py:76, :292, :446, :552",
                 wide_decode_errs["wide_tile"],
                 {f"tile_resume_{'' if d == WIDE_TIMED_DIMS[0] else f'd{d}_'}{kernel}_{k}": v
                  for d, rows in wide_tile_variants.items() for kernel, row in rows.items()
                  for k, v in row.items() if k != "device_kernels"},
                 f"kernels 1-5 at D > 256 and n > 4, bf16 q (tensor cores, P as a bf16 pair); resume "
                 f"n=1280 S=1281 B=4 H=16 D={WIDE_TIMED_DIMS[0]} lengths 1280 (d<D>_bf16_<shape>_*: "
                 f"D={WIDE_TIMED_DIMS[1]} and the prefill n=257 lengths 257); library_ms is SDPA's "
                 f"causal forward over the live keys; tile_resume_<kernel>_*: kernels 3-5 at the resume "
                 f"shape at D={WIDE_TIMED_DIMS[0]} (tile_resume_d{WIDE_TIMED_DIMS[1]}_<kernel>_*: at "
                 f"D={WIDE_TIMED_DIMS[1]}); launches: phase 4's bf16 dim_head "
                 f"{WIDE_IDENTITY_DIM} model (prefill and resume); max_abs_err: worst of phase 2's "
                 "wide decode checks on this kernel"),
                ("wide_tile_f32", "wide_tile_f32", "wide_head", (WIDE_TIMED_DIMS[0], "fp32", "resume"),
                 "dalle_pytorch_tpu/ops/pallas_decode.py:76, :292, :446, :552",
                 wide_decode_errs["wide_tile_f32"],
                 {f"tile_resume_{'' if d == WIDE_TIMED_DIMS[0] else f'd{d}_'}{kernel}_{k}": v
                  for d, rows in wide_f32_variants.items() for kernel, row in rows.items()
                  for k, v in row.items() if k != "device_kernels"},
                 f"kernels 1-5 at D > 256 and n > 4, fp32 q: wide_decode_fma_kernel<KV, cols> "
                 f"(register-tiled CUDA-core kernel, S once per column group); fp32 resume n=1280 "
                 f"S=1281 B=4 H=16 D={WIDE_TIMED_DIMS[0]} lengths 1280 (d<D>_fp32_<shape>_*: "
                 f"D={WIDE_TIMED_DIMS[1]} and the prefill n=257), bound at the fp32 peak; device ms "
                 + ", ".join(f"D={d} {shape} {wide_times['wide_tile_f32'][(d, 'fp32', shape)]['device_ms']:.3f}"
                             f" against SDPA's {wide_times['wide_tile_f32'][(d, 'fp32', shape)]['library_device_ms']:.3f}"
                             for d in WIDE_TIMED_DIMS for shape in WIDE_SHAPES)
                 + f"; library_ms is SDPA's causal forward in fp32 over the live keys; tile_resume_"
                 f"<kernel>_*: kernels 2-5 at the resume shape (SDPA with the same mask) at "
                 f"D={WIDE_TIMED_DIMS[0]} (tile_resume_d{WIDE_TIMED_DIMS[1]}_<kernel>_*: at "
                 f"D={WIDE_TIMED_DIMS[1]}); launches: phase 4's fp32 dim_head {WIDE_IDENTITY_DIM} model "
                 "(prefill and resume); max_abs_err: worst of phase 2's wide decode checks on this kernel"),
                ("wide_attention_fwd", "wide_attention_fwd", "wide_head",
                 (WIDE_TIMED_DIMS[0], "bf16", "train"), "dalle_pytorch_tpu/ops/pallas_attention.py:129",
                 wide_attn_errs["bf16"]["wide_flash_attention_fwd"],
                 {"fp32_max_abs_err": wide_attn_errs["fp32"]["wide_flash_attention_fwd"],
                  "fp32_launches": fp32_fwd},
                 f"bf16 causal B=4 H=16 N=1280 D={WIDE_TIMED_DIMS[0]} on tensor cores (`cuda_kernel`, "
                 f"`groups` column groups; d<D>_<dtype>_train_*: the other D and fp32, fp32 bound at the "
                 f"fp32 peak); fp32 on the register-tiled CUDA-core wide_fwd_fma_kernel<cols>, S once "
                 f"per column group (device ms "
                 + ", ".join(f"D={d} {wide_times['wide_attention_fwd'][(d, 'fp32', 'train')]['device_ms']:.3f}"
                             f" against SDPA's {wide_times['wide_attention_fwd'][(d, 'fp32', 'train')]['library_device_ms']:.3f}"
                             for d in WIDE_TIMED_DIMS)
                 + "; SDPA's fp32 kernels in d<D>_fp32_train_library_cuda_kernel); launches: phase 4's "
                 f"dim_head {WIDE_IDENTITY_DIM} model (training, fp32 and bf16 autocast; `_mma` launches "
                 "the bf16 ones, fp32_launches the fp32 run's)"),
                ("wide_attention_bwd", "wide_attention_bwd", "wide_head",
                 (WIDE_TIMED_DIMS[0], "bf16", "train"),
                 "dalle_pytorch_tpu/ops/pallas_attention.py:274, dalle_pytorch_tpu/ops/pallas_attention.py:333",
                 wide_attn_errs["bf16"]["wide_flash_attention_bwd"],
                 {"fp32_max_abs_err": wide_attn_errs["fp32"]["wide_flash_attention_bwd"],
                  "fp32_launches": fp32_bwd},
                 f"bf16 causal B=4 H=16 N=1280 D={WIDE_TIMED_DIMS[0]}, one fused tensor-core kernel for "
                 "dq, dk and dv (with the workspace memset and dq conversion); fp32 (d<D>_fp32_train_*, "
                 "D=" + " and ".join(map(str, WIDE_TIMED_DIMS)) + ", bound at the fp32 peak) two "
                 "register-tiled CUDA-core passes, wide_dq_fma_kernel then wide_dkv_fma_kernel, S and "
                 "dP formed once per column group (`cuda_kernel`; its device ms "
                 + ", ".join(f"D={d} {wide_times['wide_attention_bwd'][(d, 'fp32', 'train')]['device_ms']:.3f}"
                             f" against SDPA's {wide_times['wide_attention_bwd'][(d, 'fp32', 'train')]['library_device_ms']:.3f}"
                             for d in WIDE_TIMED_DIMS)
                 + "; SDPA's fp32 kernels in d<D>_fp32_train_library_cuda_kernel); library_ms is SDPA's "
                 f"whole backward; launches: phase 4's dim_head {WIDE_IDENTITY_DIM} model (training; "
                 f"fp32_launches: the fp32 run's calls, two kernels each)"),
            )
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
