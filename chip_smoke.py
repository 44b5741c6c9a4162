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
7. the continuous-serving path: phase 5's model's first 2 layers (a
   depth cut that holds the script's time) behind a `ContinuousEngine`
   (4 slots, prefill waves of 4, chunks of 4 tokens) driven by the
   `ContinuousBatcher` with phase 5's four prompts, two of them admitted
   mid-flight: causal (tokens identical to a `GenerationEngine`'s over
   the same layers, one chunk run under CUDA's sync-debug "error" mode),
   int8 KV and policy sparsity (tokens identical to that causal run); a
   slot's KV bytes at depth 12 six times depth 2's; and policy + int8 on
   a model of 4 layers, full / axial_row / axial_col / conv_like;
   each run's kernel launches counted exactly;
8. the paged-serving path: phase 7's depth-2 model behind a
   `PagedContinuousEngine` (4 slots, page 32, prefill waves of 4, chunks
   of 4) and the `ContinuousBatcher`, with phase 7's four requests and
   repeats of the first two (full-prompt prefix hits, no prefill
   dispatch), three times: the gather impl (tokens identical to phase 7's
   causal run of that model), the paged
   kernel with a pool of two rows' worst case beside the prefix cache
   (the batcher holds requests back; tokens identical again; one chunk
   under sync-debug "error"), and the block-sparse paged kernel's int8 arm
   under policy + int8 on phase 7's patterned model (tokens identical to
   phase 7's run of it); launches counted exactly, `leak_check()` empty;
9. the generation CLI (`python -m dalle_pytorch_tpu_torch.generate`, run
   in-process) on a flagship-width checkpoint (depth 2, a cut that holds
   the script's time) of the default 32k vocabulary
   with a CLIP checkpoint at the reference defaults: two prompts of 4
   images with CLIP reranking (PNGs read back with zlib, 2,050
   flash-decode launches per batch, scores best first), one `--gentxt`
   run, and the uncached `generate_images` oracle primed with the cached
   run's first 1008 tokens (2 flash-attention forwards per sampled
   position, the cached tokens wherever the noised-score margin passes
   ORACLE_MARGIN); the wall of each stage;
10. mid-decode resume and decode-state migration: phase 7's depth-2
   model behind a `ContinuousEngine` with resume and previews, then a
   `PagedContinuousEngine` (page 32, the paged kernel), then int8 KV,
   each behind the `ContinuousBatcher` with
   phase 7's four requests (request 0 streamed; requests 2-3 admitted
   after ADMIT_AFTER chunks): at the first chunk boundary at which every
   row has passed image position DRAIN_AT (fixed chunk counts, not host
   timing), `migrate_out` exports them, the checkpoints
   travel encode -> wire -> decode, and a fresh engine over the same
   weights (equal fingerprint) resumes them in one dispatch (a
   flash-decode launch a layer at n = 1280). Held: tokens equal to
   the uninterrupted run (phase 7's) up to each row's first position
   whose noised-score margin is under ORACLE_MARGIN, the resumed pending
   logits and K/V against the drained engine's (RESUME_LOGIT_TOL,
   RESUME_KV_TOL), every launch counted exactly, the decoded-token
   counter at the positions past each k, the streams' events in order,
   `leak_check()` empty, a post-resume chunk under sync-debug "error",
   each resume dispatch launching the tile arm once a layer;
   the resume dispatch's wall and device time, the export and codec
   walls (the streams' terminal events are written from the resolved
   requests as the HTTP server's reader writes them, `end_stream`);
11. the serving front end over HTTP (the port's `ServingServer` on
   127.0.0.1, port 0, in-process; `urllib` only): (a) phase 5's warmed
   micro engine behind it, phase 5's four prompts and seeds posted in
   order and coalesced into one batch: tokens identical to phase 5's,
   12,300 flash-decode launches, PNGs decoded to 256x256x3, /healthz
   200, the HTTP wall beside phase 5's `generate()` wall; (b) phase 7's
   depth-2 model behind a `ContinuousEngine` (resume and previews on):
   four low requests (request 0 over SSE) under a chunk failed by a
   `FaultInjector` (all four retried from position 0) and, after
   QOS_HIGH_AT chunks, a high one repeating request 1 that preempts the
   youngest low, which resumes at its position (tokens identical to
   phase 7's depth-2 run, the preempted one by the margin rule; the
   stream's events; launches exact); a drain with migration past
   DRAIN_AT (409s with checkpoints, /healthz 503, then 200 resumes by the
   margin rule with `usage.resumed_tokens` at each position); a request
   timing out mid-decode (504, its slot freed);
12. the trainer (`python -m dalle_pytorch_tpu_torch.train_dalle`, run
   in-process) at the flagship width, depth TRAINER_DEPTH (2; a cut that holds its time)
   (forward_reverse_partial, bf16 autocast, batch 4 of rainbow:32): a
   seeded 256 px dVAE checkpoint, its encode on the card held to its CPU
   run (VAE_ENCODE_TOL); run A (one epoch: the in-step encode, step
   checkpoints at 4 and 8, one sample at step 5), run B (`--resume
   --epochs 2`: step 8, Adam count 8 and the plateau state restored,
   steps 9-16); flash-attention launches counted exactly around each run
   (2 x depth a step each way), the sample's flash-decode launches, the
   losses finite, the final export served by `engine_from_checkpoint`;
   ms a step, samples a second, MFU, input wait, checkpoint and export
   seconds and peak memory printed;
13. the rest of training, at phase 12's model (flagship width, depth
   REST_DEPTH, the 8k native vocabulary, bf16 autocast,
   forward_reverse_partial): (a) the trainer with
   `model.reversible_impl=revnet` (5 steps) and the same run with
   `revnet_naive`, flash-attention launches counted exactly (the RevNet:
   each objective's forward plus its backward's recompute, one backward a
   layer and objective), ms a step and peak memory of both; (b) on one
   batch the RevNet's gradients against revnet_naive's in float32 and
   bf16 (REVNET_GRAD_TOL), the losses identical, and (last, after the
   timed parts) a trace of the bf16 RevNet step naming
   fwd_wgmma_kernel<64> and bwd_mma_kernel; (c) the RevNet export
   served by `engine_from_checkpoint` (its two-stream cached branch:
   flash decode once a layer a step, the prefill on the tile arm), its
   greedy tokens held to a teacher-forced uncached oracle's on the first
   REST_ORACLE_POSITIONS positions wherever its top-2 gap is at least
   ORACLE_MARGIN; (d) a 2-step run
   with `model.executor=scan`, `--dalle_path` resuming its scan export
   (Adam count 2) and `engine_from_checkpoint` loading it; (e)
   `train_vae` at 256 px (straight-through, ReinMax; its encode held to
   its CPU run) and `train_clip` at its defaults (its scores held to its
   CPU run, CLIP_SCORE_TOL); (f) the OpenAI dVAE and VQGAN wrappers from
   synthetic checkpoints at the released geometries (the VQGAN config
   written as JSON), each held to its CPU run (WRAPPER_SCORE_TOL,
   WRAPPER_DECODE_TOL); each part's wall printed;
14. (run between phases 12 and 13: phase 13 ends with a profiler trace,
   which would stay attached to phase 14's launches) tensor-parallel
   serving (`serving/sharded.py`) at the flagship width
   on the model's first SHORT_DEPTH layers, with tp = 2 shards both on
   the one card (devices [cuda:0, cuda:0]), so every kernel launches at
   H = 8: (a) kernels 1-5, bf16 and int8 K/V, at the step (n = 1), the
   prefill (n = 257) and the resume (n = 1280) shapes, the two shards'
   H = 8 launches joined by head `torch.equal` to the H = 16 launch and
   each shard within decode_tol of its plain version, the device ms of an
   H = 8 and an H = 16 step of kernels 1 and 4; (b) tp = 1 sharded slotted
   and paged engines on cuda:0, tokens bit-identical to phase 7's depth-2
   causal run; tp = 2 sharded slotted and paged (paged kernel, one
   prefix-cache hit, one resume) engines, tokens equal to that run's up to
   each row's first position whose noised-score margin is under
   ORACLE_MARGIN, first-position logits within TP_LOGIT_TOL, every decode
   launch at H = 8 and each kernel's count twice the unsharded run's; (c)
   `python -m dalle_pytorch_tpu_torch.serve --engine continuous --mesh
   tp=1` on a depth-SHORT_DEPTH checkpoint (started first, it loads while
   (a) and (b) run): one request answered over HTTP, /healthz with the
   mesh block; `--mesh tp=2` on the one card exits nonzero with "needs 2
   devices".

15. (run after phase 14, before phase 13's trace) multi-process training
   through the launch twin (`python -m dalle_pytorch_tpu_torch.launch
   --nproc_per_host 2 -- chip_smoke.py --train-rank ...`, each rank the
   trainer twin in-process), two ranks on the one card over Gloo, phase
   13's model (flagship width, depth TRAINER_DEPTH, bf16 autocast, a
   global batch of 4, 3 steps): fsdp = 2 (the flash-attention kernels on
   each rank, one in-loop sample on both over the gathered parameters)
   against one process, then in the same launch sp = 2 with
   `attn_impl="ring"` (the ring's hops staged through host memory and
   counted) against the one-process ring; per-step losses within
   MULTI_LOSS_RTOL, the first averaged gradient within MULTI_GRAD_RTOL and
   the export's change over the run within MULTI_UPDATE_RTOL (the worst
   parameter's relative 2-norm; limits set between sound and
   planted-fault readings on the card,
   `scripts/torch_multi_fault_probe.py`); then a one-rank NCCL group
   in this process runs each call of `parallel/collectives.py` once on a
   CUDA tensor.

Phases 2 and 3 also hold and time flash decode's tile arms
(`flash_decode_tile.cu`: bf16 q at n > 4 rows, P carried as a bf16 pair;
`flash_decode_tile_f32.cu`: fp32 q at n > 4; both cache arms) at the
prefill chunk (n = 257) and the resume forward's shape (n = 1280 rows over
a 1281-slot cache; B = 1 and 4), against the plain version and each arm's
model, on caches poisoned with NaN past each row's length, beside SDPA's
causal forward (and, bf16, `flash_attention_fwd`) over the live keys, and
check that each such call launches its arm once (phase 5: 12 tile
launches a generate(), phase 10: one a layer per resume dispatch). They
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

import faulthandler
import json
import math
import os
import re
import signal
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


# The script's own deadline, under the 1200 s a run of it may take: past
# it the watchdog writes every thread's stack to stderr, kills the
# process groups of the children it started (`CHILDREN`) and exits 1, so
# a hang names where it hung instead of running out the clock.
DEADLINE_S = 1140.0
CHILDREN = []  # Popen objects, each the leader of its own process group
PROGRESS = [time.perf_counter(), "start"]  # the watchdog's clock and the phase under way


def progress(phase: str) -> None:
    """Mark `phase` as begun, on stderr (flushed: the end of stderr names
    the phase a run that was stopped was in)."""
    PROGRESS[1] = phase
    print(f"chip_smoke: {phase} at {time.perf_counter() - PROGRESS[0]:.1f} s", file=sys.stderr, flush=True)


def kill_group(proc) -> None:
    """SIGKILL `proc`'s process group (started with start_new_session)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def start_watchdog() -> None:
    def expire():
        print(f"chip_smoke: past its {DEADLINE_S:.0f} s deadline in {PROGRESS[1]}; the stacks:",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for proc in list(CHILDREN):
            kill_group(proc)
        sys.stderr.flush()
        os._exit(1)

    timer = threading.Timer(DEADLINE_S - (time.perf_counter() - PROGRESS[0]), expire)
    timer.daemon = True
    timer.start()


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


# traces of one call or row taken before it fails: the profiler can drop a
# whole trace after dozens of traces in one process, and more often after
# many launches made with the tracer attached
TRACE_ATTEMPTS = 3
# [traces taken, [(call, attempts) of each trace that needed more than one]],
# printed at the end (`trace_attempts_line`)
TRACE_LOG = [0, []]


def traced(name, attempt_fn):
    """Run `attempt_fn()` (one trace; it returns what it kept, falsy when
    the profiler dropped the whole trace) up to TRACE_ATTEMPTS times;
    returns the last result and logs the attempts into TRACE_LOG."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        kept = attempt_fn()
        if kept:
            break
    TRACE_LOG[0] += 1
    if attempt > 1:
        TRACE_LOG[1].append((name, attempt))
    return kept


def trace_attempts_line():
    retried = TRACE_LOG[1]
    return (f"profiler traces: {TRACE_LOG[0]} taken, {len(retried)} retried (limit {TRACE_ATTEMPTS} attempts)"
            + (": " + ", ".join(f"{n} {a} attempts" for n, a in retried) if retried else ""))


def launched_kernel(torch, fn, args):
    """The device kernel that one call fn(*args) launches, as a
    torch.profiler trace of that call names it ("fwd_wgmma_kernel<64>");
    fails unless the trace holds exactly one kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()

    def attempt():  # a trace the profiler dropped whole is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        return [
            evt.name for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation
        ]

    names = traced(fn.__name__, attempt)
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
    is taken again, up to TRACE_ATTEMPTS times. Traces slow the launches after
    them, so these run after every other timed phase."""
    from torch.profiler import ProfilerActivity, profile

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()

    def attempt():
        times = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for it in range(iters):
                fn(*inputs[it % len(inputs)])
            torch.cuda.synchronize()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
                found = re.search(r"\w+_kernel<[^<>]*>|\w+_kernel\b", evt.name)
                name = found.group(0) if found else evt.name[:60]
                times.setdefault(name, []).append(evt.time_range.elapsed_us())
        return times

    times = traced(getattr(fn, "__name__", str(fn)), attempt)
    if not times:
        fail(f"{getattr(fn, '__name__', fn)}: {TRACE_ATTEMPTS} traces of {iters} calls held no device activity")
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
# phases 7, 8 and 10 drive the batcher directly: no request of theirs may
# time out or be shed (the batcher's default timeout is the server's 120 s)
BATCH_TIMEOUT_S = 3600.0


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
    reqs = [batcher.submit([sp], timeout_s=BATCH_TIMEOUT_S) for sp in specs[:2]]
    while engine.stats.chunks < 8 and not all(r.future.done() for r in reqs):
        time.sleep(0.002)
    reqs += [batcher.submit([sp], timeout_s=BATCH_TIMEOUT_S) for sp in specs[2:]]
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


SHORT_DEPTH = 2  # phases 7-11 and 14 (bar phase 11a): a depth cut that holds the script's time
PATTERNED_DEPTH = len(PATTERNED)  # the patterned model: each attention type once


def first_layers(torch, model, depth):
    """A DALLE of `depth` layers on the card holding `model`'s embeddings,
    head and first `depth` layers (bfloat16, eval)."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    with torch.device("cuda"):
        short = DALLE(**{**FLAGSHIP, "depth": depth})
    own = short.state_dict()
    short.load_state_dict({k: v for k, v in model.state_dict().items() if k in own})
    return short.to(torch.bfloat16).eval()


def run_continuous(torch, model, vae, specs):
    """Phase 7: the four runs. Returns ({kernel: launches on its run}, the
    patterned model and its policy + int8 tokens, and the depth-cut
    model's causal and int8 runs' tokens)."""
    import copy

    import numpy as np

    from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, GenerationEngine

    def only(launches, kernel, expected, label):
        """`kernel` alone launched, `expected` times in all; of those one
        tile-arm launch a layer for each prefill wave (n = 257)."""
        others = {k: n for k, n in launches.items() if k != kernel and not k.endswith("_tile") and n}
        tile = launches[kernel + "_tile"]
        if launches[kernel] != expected or others or tile != engine.model.depth * engine.stats.prefill_dispatches:
            fail(f"continuous {label}: {kernel} launched {launches[kernel]} times "
                 f"(expected {expected}; tile arm {tile}), others {others}")

    # 1. causal on the model's first SHORT_DEPTH layers (a depth cut that
    # holds the script's time): the micro engine's tokens over the same
    # layers, and a chunk with no host sync
    short = first_layers(torch, model, SHORT_DEPTH)
    micro_tokens, _ = GenerationEngine(short, vae, batch_shapes=(4,), device="cuda").generate(specs)
    label = f"causal depth {SHORT_DEPTH}"
    engine, toks_short, _, launches, expected = serve_continuous(torch, short, vae, specs, label)
    same = np.array_equal(toks_short, micro_tokens)
    print(f"check continuous {label} tokens identical to the micro engine's over the same layers: {same} "
          f"(agreement {(toks_short == micro_tokens).mean():.6f})")
    if not same:
        fail("the continuous engine's tokens differ from the micro engine's")
    only(launches, "flash_decode", expected, label)
    short_bytes = engine.kv_bytes_per_slot()
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
    # the KV bytes of a slot scale with depth: the flagship's engine, built, not served
    causal_bytes = ContinuousEngine(model, vae, **CONTINUOUS, tokenizer=ByteTokenizer(),
                                    device="cuda").kv_bytes_per_slot()
    out = {}

    # 2-3. int8 KV and policy on the same layers, held against their causal run
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

    # 4. policy + int8 on the patterned model (flagship width, PATTERNED_DEPTH)
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        patterned = DALLE(**{**FLAGSHIP, "depth": PATTERNED_DEPTH, "attn_types": PATTERNED})
        patterned = patterned.to(torch.bfloat16).eval()
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
    return out, patterned, toks4, (toks_short, toks2)


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
    reqs = [batcher.submit([sp], timeout_s=BATCH_TIMEOUT_S) for sp in specs[:2]]
    while engine.stats.chunks < 8 and not all(r.future.done() for r in reqs):
        time.sleep(0.002)
    reqs += [batcher.submit([sp], timeout_s=BATCH_TIMEOUT_S) for sp in specs[2:] + specs[:2]]
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


def run_paged(torch, model, patterned, vae, specs, patterned_tokens, short_tokens):
    """Phase 8: the three runs of the PagedContinuousEngine at the flagship
    width. Returns {kernel: launches on its run} for kernels 4 and 5."""
    # 1-2. on the model's first SHORT_DEPTH layers (a depth cut that holds
    # the script's time), held to phase 7's causal run of that model:
    # 1. the reference's default impl, paged_gather + kernel 1
    short = first_layers(torch, model, SHORT_DEPTH)
    label = f"gather causal depth {SHORT_DEPTH}"
    engine, toks1, launches, waves = serve_paged(torch, short, vae, specs, label, paged_decode_impl="gather")
    check_paged_run(engine, toks1, launches, waves, label, "flash_decode", "flash_decode", short_tokens)
    del engine

    # 2. kernel 4, with a pool of two rows' worst case beside the prefix
    # cache's four entries (8 full pages and a snapshot page each)
    per_row = -(-(FLAGSHIP["text_seq_len"] + 1024 + 1) // PAGE)  # 41
    text_pages = -(-(FLAGSHIP["text_seq_len"] + 1) // PAGE)  # 9: 8 full and the snapshot
    kv_pages = 1 + 2 * per_row + len(PROMPTS) * text_pages
    label = f"kernel causal depth {SHORT_DEPTH}, small pool"
    engine, toks2, launches, waves = serve_paged(torch, short, vae, specs, label,
                                                 paged_decode_impl="kernel", kv_pages=kv_pages)
    check_paged_run(engine, toks2, launches, waves, label, "paged_flash_decode", "flash_decode", short_tokens)
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
    del engine, short

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
CLI_DEPTH = SHORT_DEPTH  # a depth cut that holds the script's time
CLI_PROMPTS = "a red cube|a blue sphere"
CLI_IMAGES = 4  # per prompt, one batch of 4
ORACLE_PRIMED = 1008  # the oracle samples the last 16 image positions
# the noised-score margin above which the uncached oracle must pick the
# cached run's token: twice the largest bf16 logit difference between the
# two paths must stay below it (measured and printed beside it)
ORACLE_MARGIN = 0.1


def run_generation_cli(torch, vae):
    """Phase 9: the generation CLI (`dalle_pytorch_tpu_torch.generate.main`,
    in-process) on a flagship-width checkpoint of depth CLI_DEPTH whose
    config names no vocabulary (the default 32k native BPE), random
    weights from SEED, bf16, with `vae` inside, and a CLIP checkpoint at
    the reference defaults: two prompts x 4 images with CLIP reranking (4
    PNGs and a grid per prompt read back with zlib, CLI_DEPTH x 1025
    flash-decode launches per batch, scores best first), one `--gentxt`
    run, and the uncached `generate_images` oracle primed with the cached
    run's first ORACLE_PRIMED tokens of prompt 0 (the same row seeds, so
    the last 16 positions sample the same noise): CLI_DEPTH
    flash-attention forwards a sampled position, tokens equal
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
        model = DALLE(**{**FLAGSHIP, "depth": CLI_DEPTH, "num_text_tokens": vocab}).to(torch.bfloat16).eval()
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
    expected = len(prompts) * CLI_DEPTH * (1 + FLAGSHIP["image_fmap_size"] ** 2)
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
    if launches["oracle_flash_attention_fwd"] != CLI_DEPTH * sampled:
        fail(f"the oracle launched flash_attention_fwd {launches['oracle_flash_attention_fwd']} "
             f"times, expected {CLI_DEPTH * sampled}")
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
        attn = engine._state["shards"][0]["cache"][f"layer_{i}"]["attn"]

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


def end_stream(stream, req):
    """The terminal event of a stream the batcher fed, written from the
    resolved request as the HTTP server's reader writes it (phase 11 holds
    the server's own): "migrated" with the checkpoint, or "result" with
    the tokens."""
    import numpy as np

    from dalle_pytorch_tpu_torch.serving.migrate import MigratedError, to_wire

    try:
        tokens, _ = req.future.result(0)
    except MigratedError as exc:
        cp = exc.checkpoint  # the batcher encoded it once, at the export
        stream.finish("migrated", checkpoint=to_wire(cp.encoded), resumed_at_chunk=int(cp.chunk_index),
                      migrated_from=cp.site)
        return
    stream.finish("result", num_images=req.rows, tokens=np.asarray(tokens).tolist())


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
        reqs = [batcher.submit([specs[0]], request_key="r0", stream=stream, timeout_s=BATCH_TIMEOUT_S),
                batcher.submit([specs[1]], request_key="r1", timeout_s=BATCH_TIMEOUT_S)]
    if not at_admit.wait(600):
        fail(f"{label}: the first two requests never ran {ADMIT_AFTER} chunks")
    reqs += [batcher.submit([sp], request_key=f"r{i}", timeout_s=BATCH_TIMEOUT_S)
             for i, sp in enumerate(specs[2:], 2)]
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
                row=eng_a._state["shards"][0]["row"][slots].float().clone(), kv=kv_rows(torch, eng_a, slots),
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
    end_stream(stream_a, reqs[0])
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
                       row=eng_b._state["shards"][0]["row"][slots].float().clone(), kv=kv_rows(torch, eng_b, slots))

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
                             stream=stream_b if i == 0 else None, timeout_s=BATCH_TIMEOUT_S)
            for i, (sp, (cp, size)) in enumerate(zip(specs, valid))]
    outs = [r.future.result(timeout=900) for r in reqs]
    resume_run_s = time.perf_counter() - t_run
    end_stream(stream_b, reqs[0])
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


def run_migration(torch, model, vae, specs, short_tokens, int8_tokens):
    """Phase 10: the slotted and the paged (kernel impl) engines, then int8
    KV, each on phase 7's depth-SHORT_DEPTH model (the flagship width).
    Returns the three summaries."""
    short = first_layers(torch, model, SHORT_DEPTH)
    slotted = serve_migrated(torch, short, vae, specs, short_tokens, f"slotted causal depth {SHORT_DEPTH}")
    paged = serve_migrated(torch, short, vae, specs, short_tokens, f"paged kernel causal depth {SHORT_DEPTH}",
                           paged=True, paged_decode_impl="kernel")
    int8 = serve_migrated(torch, short, vae, specs, int8_tokens, f"slotted int8 depth {SHORT_DEPTH}",
                          kv_dtype="int8")
    return slotted, paged, int8


# --------------------------------------------------------------- phase 11

SERVE_TIMEOUT_S = 600.0  # phase 11's servers' request_timeout_s (each request's default)
MICRO_DELAY_MS = 20000.0  # the micro server's flush deadline: its four posts coalesce first
POST_STAGGER_S = 0.25  # phase 11a's posts arrive in phase 5's order, this far apart
QOS_HIGH_AT = 128  # phase 11b: the chunk after which the high request arrives
RETRY_FAIL_CHUNK = 12  # phase 11b: the chunk dispatch, counted from the first request, that fails
REQUEST_TIMEOUT_S = 2.0  # phase 11b: a timeout that expires mid-decode


def http_call(port, method, path, body=None, headers=None, timeout=SERVE_TIMEOUT_S + 60):
    """(status, headers, JSON or text) of one request to the local server,
    urllib only; an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if body is None else (json.dumps(body).encode() if isinstance(body, dict) else body)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as err:
        resp = err
    with resp:
        raw = resp.read()
        kind = resp.headers.get("Content-Type", "")
        return resp.status, dict(resp.headers), json.loads(raw) if kind.startswith("application/json") else raw.decode()


def http_metric(port, name):
    """One unlabeled sample of GET /metrics (0.0 when absent)."""
    _, _, text = http_call(port, "GET", "/metrics")
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def http_stage_sums(port):
    """{stage: seconds} of the server's `dalle_serving_stage_seconds` sums."""
    _, _, text = http_call(port, "GET", "/metrics")
    out = {}
    for line in text.splitlines():
        m = re.match(r'dalle_serving_stage_seconds_sum\{stage="(\w+)"\} (\S+)', line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def stage_delta(before, after):
    """Seconds each stage took between two `http_stage_sums` reads."""
    return {k: round(v - before.get(k, 0.0), 3) for k, v in sorted(after.items()) if v - before.get(k, 0.0) > 0}


def post_async(port, body, headers=None):
    """POST /generate on a thread: (thread, its result holder)."""
    out = {}
    thread = threading.Thread(
        target=lambda: out.update(r=http_call(port, "POST", "/generate", body, headers)), daemon=True
    )
    thread.start()
    return thread, out


def post_result(posted, label):
    thread, out = posted
    thread.join(SERVE_TIMEOUT_S + 120)
    if "r" not in out:
        fail(f"{label}: no reply")
    return out["r"]


def wait_accepted(port, n, label):
    """Until the server's queue has accepted `n` requests in all."""
    deadline = time.monotonic() + 120
    while http_metric(port, "dalle_serving_requests_total") < n:
        if time.monotonic() > deadline:
            fail(f"{label}: request {n} was never accepted")
        time.sleep(0.005)


def png_shapes(payload):
    """Shapes of a payload's images, decoded with zlib."""
    import base64

    from dalle_pytorch_tpu_torch.utils.images import decode_png

    return [decode_png(base64.b64decode(b)).shape for b in payload.get("images_png_b64", [])]


def sse_collect(port, body, out):
    """A streamed POST /generate read to its end: out["status"], and
    out["events"] as (type, data, seq) from the port's SSE parser."""
    import urllib.request

    from dalle_pytorch_tpu_torch.serving.streaming import SSEParser

    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", method="POST",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S + 60) as resp:
        out["status"] = resp.status
        parser, events = SSEParser(), out.setdefault("events", [])
        for line in resp:
            events.extend(parser.feed(line))


def margin_rule(margins, row, tokens, reference, k):
    """Phase 10's rule: (ok, first divergence, first sub-margin position
    from k). The row must equal `reference` up to its first position at or
    past k whose noised-score margin is under ORACLE_MARGIN, and below k."""
    import numpy as np

    low = np.flatnonzero(margins[row, k:] < ORACLE_MARGIN)
    diff = np.flatnonzero(np.asarray(tokens) != reference[row])
    first_low = int(k + low[0]) if low.size else None
    first_diff = int(diff[0]) if diff.size else None
    ok = first_diff is None or (first_diff >= k and first_low is not None and first_diff >= first_low)
    return ok, first_diff, first_low


def run_micro_server(torch, engine, tokens5, wall5):
    """Phase 11a: phase 5's warmed micro engine (depth 12, bf16, batch 4)
    behind the port's ServingServer, no second warmup. Phase 5's four
    prompts and seeds arrive as four POST /generate, in order, and
    coalesce into one batch. Held: one batch of 4 rows (/metrics), tokens
    identical to phase 5's, each PNG 256x256x3, 12,300 flash-decode
    launches (12 of them the prefill's tile arm), /healthz 200. Printed:
    the HTTP wall from the post that completes the batch, the batch's
    `generate()` wall inside the server (`dalle_serving_batch_seconds`)
    and phase 5's; their difference is the server's cost."""
    import numpy as np

    from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention as fda
    from dalle_pytorch_tpu_torch.serving.server import ServingServer

    server = ServingServer(engine, port=0, max_delay_ms=MICRO_DELAY_MS, request_timeout_s=SERVE_TIMEOUT_S).start()
    try:
        port = server.port
        fda.launches = fda.tile_launches = 0
        t0 = time.perf_counter()
        posted = []
        for i, prompt in enumerate(PROMPTS):
            if i:
                time.sleep(POST_STAGGER_S)
            t_last = time.perf_counter()
            posted.append(post_async(port, {"prompt": prompt, "seed": 100 + i, "temperature": 1.0, "top_k": 0.9}))
        replies = [post_result(p, "micro server") for p in posted]
        t_end = time.perf_counter()
        launches = {"flash_decode": fda.launches, "flash_decode_tile": fda.tile_launches}
        health, _, _ = http_call(port, "GET", "/healthz")
        batches = http_metric(port, "dalle_serving_batches_total")
        rows = http_metric(port, "dalle_serving_batch_occupancy_rows_sum")
        engine_s = http_metric(port, "dalle_serving_batch_seconds_sum")  # generate() inside the server
    finally:
        server.shutdown()
    statuses = [status for status, _, _ in replies]
    same = [status == 200 and np.array_equal(np.asarray(p["tokens"]), tokens5[i : i + 1])
            for i, (status, _, p) in enumerate(replies)]
    shapes = [png_shapes(p) if status == 200 else [] for status, _, p in replies]
    size, depth = engine.vae.image_size, engine.model.depth
    summary = dict(
        statuses=statuses, tokens_identical_to_phase5=same, png_shapes=[[list(s) for s in x] for x in shapes],
        launches=launches, batches=batches, occupancy_rows=rows, healthz=health,
        http_wall_s=t_end - t0, http_wall_from_last_post_s=t_end - t_last, phase5_generate_wall_s=wall5,
        generate_in_server_s=engine_s, server_cost_s=(t_end - t_last) - engine_s,
        http_minus_phase5_s=(t_end - t_last) - wall5,
    )
    print("micro server " + json.dumps(summary))
    if statuses != [200] * 4 or not all(same):
        fail(f"micro server: statuses {statuses}, tokens identical to phase 5's {same}")
    if any(x != [(size, size, 3)] for x in shapes):
        fail(f"micro server: PNG shapes {shapes}")
    if launches != {"flash_decode": depth * (1 + engine.image_seq_len), "flash_decode_tile": depth}:
        fail(f"micro server: launches {launches}")
    if (batches, rows, health) != (1, 4, 200):
        fail(f"micro server: {batches} batches of {rows} rows, /healthz {health}")
    return summary


def run_continuous_server(torch, model, vae, specs, reference):
    """Phase 11b: phase 7's depth-2 model behind a ContinuousEngine (4
    slots, chunks of 4, resume and previews on) and the port's
    ServingServer, driven over HTTP in three parts:

    QoS and retry: four low requests (phase 7's prompts and seeds;
    request 0 over SSE) fill the slots; a FaultInjector fails the
    RETRY_FAIL_CHUNK-th chunk, so all four are retried from position 0
    (re-admitted in one wave); after QOS_HIGH_AT chunks a high request
    repeating request 1 under another tenant arrives and preempts the
    youngest low (the one whose prefill began last), which re-admits
    through `resume_slots` at its position. Held: the other low requests'
    and the high one's tokens identical to phase 7's depth-2 causal run
    (`reference`), the victim's by the margin rule from its preempted
    position; one failed chunk, four retries; the stream's progress in
    order, previews, one terminal `result` with a buffered payload's keys;
    one preemption, one resumption, one resume dispatch; launches exact.
    (Two parts in one decode: the script's time.)
    Drain: two requests; once both passed DRAIN_AT, `POST
    /admin/drain?migrate=1`: 409 with a checkpoint each, /healthz 503
    draining; after undrain both re-POSTed at once with their "resume":
    200, tokens by the margin rule, `usage.resumed_tokens` = the position.
    Each part prints its wall, chunks and the server's stage seconds
    (`dalle_serving_stage_seconds`: queue, prefill, chunk, harvest,
    preview, respond).
    Timeout: a request whose timeout expires mid-decode gets 504 and its
    slot is freed (`dalle_serving_slots_active` back to 0)."""
    import numpy as np

    from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
    from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention as fda
    from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine
    from dalle_pytorch_tpu_torch.serving.faults import FaultInjector
    from dalle_pytorch_tpu_torch.serving.migrate import decode_checkpoint, from_wire
    from dalle_pytorch_tpu_torch.serving.server import ServingServer

    short = first_layers(torch, model, SHORT_DEPTH)
    depth, seq = short.depth, short.image_seq_len
    engine = ContinuousEngine(short, vae, **CONTINUOUS, tokenizer=ByteTokenizer(),
                              device=short.text_emb.weight.device, resume_enabled=True, preview_enabled=True)
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    # park the worker after the first chunk at which park["when"](pos, act) holds
    park = {"when": None, "at": threading.Event(), "go": threading.Event(), "pos": None}
    step = engine.step_chunk

    def parking_step(*args, **kw):
        pos, act = step(*args, **kw)
        when = park["when"]
        if when is not None and when(pos, act):
            park.update(when=None, pos=pos.copy())
            park["at"].set()
            park["go"].wait(600)
        return pos, act

    def arm(when):
        park["at"].clear()
        park["go"].clear()
        park["when"] = when

    engine.step_chunk = parking_step
    margins = noised_margins(torch, short, specs, reference)
    image = [1, vae.image_size, vae.image_size, 3]

    def body(i, **kw):
        return {"prompt": PROMPTS[i], "seed": 100 + i, "temperature": 1.0, "top_k": 0.9, **kw}

    server = ServingServer(engine, port=0, request_timeout_s=SERVE_TIMEOUT_S, preview_every=PREVIEW_EVERY).start()
    port, accepted, walls = server.port, 0, {}
    summary = dict(warmup_s=warm_s)
    try:
        # --- QoS and retry: four low requests; a chunk fails under them, so
        # all four are retried from 0; a high one then preempts the youngest
        t0, stages0 = time.perf_counter(), http_stage_sums(port)
        fda.launches = fda.tile_launches = 0
        chunks0, waves0, resumes0 = engine.stats.chunks, engine.stats.prefill_dispatches, engine.stats.resume_dispatches
        retries0 = http_metric(port, "dalle_serving_dispatch_retries_total")
        engine.faults = FaultInjector().fail_nth("chunk", RETRY_FAIL_CHUNK)
        arm(lambda pos, act: engine.stats.chunks - chunks0 >= QOS_HIGH_AT)
        sse = {}
        sse_thread = threading.Thread(target=sse_collect, args=(port, body(0, priority="low"), sse), daemon=True)
        sse_thread.start()
        accepted += 1
        wait_accepted(port, accepted, "qos")
        lows = []
        for i in (1, 2, 3):
            lows.append(post_async(port, body(i, priority="low")))
            accepted += 1
            wait_accepted(port, accepted, "qos")
        if not park["at"].wait(600):
            fail(f"qos: {QOS_HIGH_AT} chunks never ran")
        _, _, state = http_call(port, "GET", "/debug/state")
        slots = state["batcher"]["slots_inflight"]
        at_park = {v["trace_id"]: int(park["pos"][int(s)]) for s, v in slots.items()}
        high = post_async(port, body(1, priority="high", tenant="vip"))
        accepted += 1
        wait_accepted(port, accepted, "qos")
        park["go"].set()
        replies = [post_result(p, "qos") for p in lows] + [post_result(high, "qos high")]
        sse_thread.join(SERVE_TIMEOUT_S + 120)
        fired, engine.faults = engine.faults.fired, None
        walls["qos_s"] = time.perf_counter() - t0
        stages = stage_delta(stages0, http_stage_sums(port))
        chunks, waves = engine.stats.chunks - chunks0, engine.stats.prefill_dispatches - waves0
        resumes = engine.stats.resume_dispatches - resumes0
        qos_launches = {"flash_decode": fda.launches, "flash_decode_tile": fda.tile_launches}
        retried = http_metric(port, "dalle_serving_dispatch_retries_total") - retries0
        preemptions = http_metric(port, 'dalle_serving_preemptions_total{reason="priority"}')
        resumptions = http_metric(port, 'dalle_serving_resumptions_total{reason="priority"}')
        retry_resumptions = http_metric(port, 'dalle_serving_resumptions_total{reason="dispatch_retry"}')
        if len(slots) != 4 or any(s["rows"] != 1 for s in slots.values()):
            fail(f"qos: {len(slots)} requests in flight at the high request's arrival: {slots}")
        statuses = [sse.get("status")] + [r[0] for r in replies]
        if statuses != [200] * 5:
            fail(f"qos: statuses {statuses}")
        events = sse.get("events", [])
        kinds = [t for t, _, _ in events]
        result = events[-1][1] if kinds and kinds[-1] == "result" else {}
        payloads = [result] + [r[2] for r in replies]  # requests 0-3, then the high one
        # the victim: the low request whose trace holds a `preempted` span
        # for priority (the retry's suspensions are spans of that name too);
        # the youngest: its (last) prefill span began last
        spans = {}
        for i, p in enumerate(payloads[:4]):
            _, _, tr = http_call(port, "GET", f"/debug/traces?trace_id={p.get('trace_id')}")
            spans[i] = [e for e in tr.get("traceEvents", []) if e.get("ph") == "X"]
        victims = [i for i in range(4)
                   if any(e["name"] == "preempted" and e["args"].get("reason") == "priority" for e in spans[i])]
        last_prefill = {i: max(e["ts"] for e in spans[i] if e["name"] == "prefill") for i in range(4)}
        youngest = max(last_prefill, key=last_prefill.get)
        if victims != [youngest]:
            fail(f"qos: preempted {victims}, the youngest admitted low request is {youngest}")
        victim = victims[0]
        k = at_park[payloads[victim]["trace_id"]]
        exact = {f"request {i}": np.array_equal(np.asarray(p["tokens"][0]), reference[i])
                 for i, p in enumerate(payloads[:4]) if i != victim}
        exact["high (request 1's)"] = np.array_equal(np.asarray(payloads[4]["tokens"][0]), reference[1])
        ok_v, diff_v, low_v = margin_rule(margins, victim, payloads[victim]["tokens"][0], reference, k)
        progress = [d["chunk"] for t, d, _ in events if t == "progress"]
        previews = [d for t, d, _ in events if t == "preview"]
        stream_ok = (
            kinds[:1] == ["open"] and kinds[-1:] == ["result"]
            and sum(kinds.count(t) for t in ("result", "error", "migrated")) == 1
            and progress and all(a < b for a, b in zip(progress, progress[1:]))
            and previews and all(d["chunk"] % PREVIEW_EVERY == 0 for d in previews)
            and all(png_shapes({"images_png_b64": d["previews_png_b64"]}) == [tuple(image[1:])] for d in previews)
            and sorted(result) == sorted(payloads[1]) and result.get("shape") == image
        )
        expected = {"flash_decode": depth * (CONTINUOUS["chunk_tokens"] * chunks + waves),
                    "flash_decode_tile": depth * waves}
        summary["qos"] = dict(
            wall_s=walls["qos_s"], chunks=chunks, ms_per_chunk=1e3 * walls["qos_s"] / chunks,
            stage_seconds=stages, prefill_waves=waves, resume_dispatches=resumes,
            fired=[f["program"] + f"#{f['nth']}" for f in fired], retried=retried,
            retry_resumptions=retry_resumptions, positions_at_high_arrival=sorted(at_park.values()),
            preempted=victim, preempted_at=k, preemptions=preemptions, resumptions=resumptions,
            tokens_identical=exact, preempted_first_divergence=diff_v, preempted_first_sub_margin=low_v,
            stream=dict(progress=progress[:3] + progress[-2:], previews=[d["chunk"] for d in previews],
                        terminal=kinds[-1:]),
            launches=qos_launches, expected_launches=expected,
        )
        print("served qos " + json.dumps(summary["qos"]))
        if not all(exact.values()) or not ok_v:
            fail(f"qos: tokens identical {exact}; the preempted request {victim} from {k}: first divergence "
                 f"{diff_v}, first sub-margin position {low_v}")
        if len(fired) != 1 or retried != 4 or retry_resumptions != 4:
            fail(f"qos: fired {fired}, retried {retried}, re-admitted after the retry {retry_resumptions}")
        if (preemptions, resumptions, resumes) != (1, 1, 1):
            fail(f"qos: preemptions {preemptions}, resumptions {resumptions}, resume dispatches {resumes}")
        if not stream_ok:
            fail(f"qos: the stream's events {kinds[:4]}...{kinds[-3:]}, progress {progress[:4]}, "
                 f"previews {[d['chunk'] for d in previews]}")
        if qos_launches != expected:
            fail(f"qos: launches {qos_launches}, expected {expected}")

        # --- drain with migration, then the resumes
        t0, stages0, chunks0 = time.perf_counter(), http_stage_sums(port), engine.stats.chunks
        arm(lambda pos, act: act.sum() == 2 and pos[act].min() >= DRAIN_AT)
        posted = []
        for i in (0, 1):
            posted.append(post_async(port, body(i), headers={"x-dalle-request-key": f"d{i}"}))
            accepted += 1
            wait_accepted(port, accepted, "drain")
        if not park["at"].wait(600):
            fail(f"drain: the rows never passed {DRAIN_AT}")
        drained = {}
        drainer = threading.Thread(target=lambda: drained.update(
            r=http_call(port, "POST", "/admin/drain?migrate=1", b"")), daemon=True)
        drainer.start()
        deadline = time.monotonic() + 60
        while server.batcher._migrate_request is None and time.monotonic() < deadline:
            time.sleep(0.001)
        park["go"].set()
        drainer.join(120)
        replies = [post_result(p, "drain") for p in posted]
        health, _, health_body = http_call(port, "GET", "/healthz")
        undrain, _, _ = http_call(port, "POST", "/admin/undrain", b"")
        cps = [decode_checkpoint(from_wire(r[2]["checkpoint"]), server.resume_fingerprint) if r[0] == 409 else None
               for r in replies]
        if [r[0] for r in replies] != [409, 409] or drained.get("r", (None,))[0] != 200:
            fail(f"drain: replies {[r[0] for r in replies]}, drain {drained.get('r', (None,))[0]}")
        if (health, health_body.get("draining"), undrain) != (503, True, 200):
            fail(f"drain: /healthz {health} {health_body.get('status')}, undrain {undrain}")
        posted = [post_async(port, body(i, resume=r[2]["checkpoint"])) for i, r in enumerate(replies)]
        resumed = [post_result(p, "resume") for p in posted]
        walls["drain_s"] = time.perf_counter() - t0
        ks = [cp.rows[0].pos for cp in cps]
        rules = [margin_rule(margins, i, r[2]["tokens"][0], reference, k) if r[0] == 200 else (False, None, None)
                 for i, (r, k) in enumerate(zip(resumed, ks))]
        usage = [r[2].get("usage") for r in resumed]
        summary["drain"] = dict(wall_s=walls["drain_s"], chunks=engine.stats.chunks - chunks0,
                                stage_seconds=stage_delta(stages0, http_stage_sums(port)),
                                drained_at=ks, statuses=[r[0] for r in resumed],
                                usage=usage, first_divergence=[x[1] for x in rules],
                                first_sub_margin=[x[2] for x in rules])
        print("served drain " + json.dumps(summary["drain"]))
        if not all(x[0] for x in rules) or [u and u["resumed_tokens"] for u in usage] != ks or min(ks) < DRAIN_AT:
            fail(f"drain: resumes {summary['drain']}")

        # --- a timeout mid-decode (under the shed's estimate: shedding off for it)
        t0 = time.perf_counter()
        server.batcher.deadline_shed = False
        status, _, _ = post_result(post_async(port, body(2, timeout_s=REQUEST_TIMEOUT_S)), "timeout")
        server.batcher.deadline_shed = True
        deadline = time.monotonic() + 30
        while http_metric(port, "dalle_serving_slots_active") != 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        walls["timeout_s"] = time.perf_counter() - t0
        slots_after = http_metric(port, "dalle_serving_slots_active")
        timeouts = http_metric(port, "dalle_serving_timeouts_total")
        summary["timeout"] = dict(wall_s=walls["timeout_s"], status=status, slots_active_after=slots_after,
                                  timeouts=timeouts)
        print("served timeout " + json.dumps(summary["timeout"]))
        if (status, slots_after, timeouts) != (504, 0, 1):
            fail(f"timeout: {summary['timeout']}")
    finally:
        park["go"].set()
        server.shutdown()
    summary["walls"] = walls
    return summary


# phase 12: the trainer end to end at flagship width
TRAINER_DEPTH = 2  # a depth cut that holds the phase's time; the width is the flagship's
TRAINER_SAMPLES = 32  # rainbow:32 at batch 4: 8 steps an epoch
TRAINER_SAVE_EVERY = 4  # run A's step checkpoints: step 4 (mid-epoch) and 8
# the dVAE encode's fp32 logits on the card against its plain CPU run
# (absolute; the logits are O(1) and each sums 1024 products in another order)
VAE_ENCODE_TOL = 1e-4


def trainer_args(run_dir, vae_path, *extra):
    """The trainer's flags for phase 12: the flagship's width (dim 1024,
    16 heads of 64, 256 text tokens, shift and rotary) at TRAINER_DEPTH,
    forward_reverse_partial, bf16 autocast, attn_impl "auto" (N = 1280
    takes the flash kernels), the plateau scheduler on, step checkpoints
    every TRAINER_SAVE_EVERY steps, the newest kept."""
    return [
        "--device", "cuda", "--image_text_folder", f"rainbow:{TRAINER_SAMPLES}",
        "--vae_path", str(vae_path), "--batch_size", "4", "--exp", "r",
        "--set", "model.dim=1024", "--set", f"model.depth={TRAINER_DEPTH}",
        "--set", "model.heads=16", "--set", "model.dim_head=64", "--set", "model.text_seq_len=256",
        "--set", "model.shift_tokens=true", "--set", "model.rotary_emb=true",
        "--set", "lr_decay=true", "--set", f"save_every_n_steps={TRAINER_SAVE_EVERY}",
        "--set", "keep_n_checkpoints=1", "--set", f"output_dir={run_dir}", *extra,
    ]


def check_vae_encode(torch, vae_path):
    """Phase 12: the dVAE's encode (the in-step encode's function) on the
    card against its plain CPU run on the same four rainbow images at
    256 px: logits within VAE_ENCODE_TOL, tokens identical wherever the
    CPU run's top-2 gap exceeds twice it. Returns (max abs error, share
    of identical tokens)."""
    import numpy as np

    from dalle_pytorch_tpu_torch.data.rainbow import RainbowDataset
    from dalle_pytorch_tpu_torch.training.pipeline import load_vae_checkpoint

    ds = RainbowDataset(num_samples=TRAINER_SAMPLES, image_size=256)
    images = torch.from_numpy(np.stack([ds.image(i) for i in range(4)]))
    vae = load_vae_checkpoint(str(vae_path)).eval()
    with torch.no_grad():
        ref = vae.encode_logits(images)
        got = vae.cuda().encode_logits(images.cuda()).cpu()
    err = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * VAE_ENCODE_TOL
    same = got.argmax(-1) == ref.argmax(-1)
    share = same.float().mean().item()
    print(f"check dVAE encode on the card vs CPU (4 x 256 px, 8192 codes): max abs err {err:.3g} "
          f"(tol {VAE_ENCODE_TOL}), identical tokens {share:.6f}, clear of the tolerance "
          f"{clear.float().mean().item():.6f}")
    if not err <= VAE_ENCODE_TOL:
        fail(f"the dVAE encode on the card is {err} from its CPU run")
    if not bool(same[clear].all()):
        fail("the dVAE encode on the card picked another token where the top-2 gap is clear")
    return err, share


def _npz_entries(path, *keys):
    """Single entries of an npz (read lazily) and its JSON metadata."""
    import numpy as np

    with np.load(path) as z:
        return json.loads(str(z["__metadata__"])), [z[k] for k in keys]


def run_trainer(torch, smi):
    """Phase 12: the trainer twin (`dalle_pytorch_tpu_torch.train_dalle.main`,
    in-process) on the card. A seeded dVAE checkpoint at the flagship
    geometry (256 px, 3 layers, 8192 codes: 1024 image tokens), its encode
    held to its CPU run; run A, `--epochs 1` on rainbow:32 at batch 4 (8
    steps, the in-step encode, step checkpoints at 4 and 8, one sample at
    step 5 through the cached sampler and the dVAE decode); run B,
    `--resume --epochs 2` from run A's directory (restores step 8, its
    Adam count and plateau state; steps 9-16). The flash-attention
    launches are read from zero around each run: 2 x depth a step each
    for the forward and the backward (two objectives); flash decode
    depth x 1025 for the sample. The final export loads through
    `engine_from_checkpoint`. The phase runs under torch's default
    precision settings (cuDNN may use TF32), as the CLI runs, not the
    script's TF32-free ones, so the encode check holds the encode's own
    float32 pin. ms_per_step is the mean of run B's eight steps, each
    timed by a CUDA event pair around it (exports, step checkpoints and
    cadence reads fall between steps); the throughput meter's reading
    (the host's clock over its last interval) is printed beside it. Peak
    memory is the runs' own, above what earlier phases still hold. The
    run directory (exports and step
    checkpoints of ~1.4 GB with the Adam state) is removed at the end.
    Returns the summary."""
    import shutil

    from dalle_pytorch_tpu_torch import train_dalle
    from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention
    from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint
    from dalle_pytorch_tpu_torch.training.pipeline import save_vae_checkpoint
    from dalle_pytorch_tpu_torch.utils.flops import mfu

    run_dir = REPO / "build" / "chip_smoke" / "trainer"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, flash_decode_attention)
    runs = {}
    script_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    # torch's defaults, as `python -m dalle_pytorch_tpu_torch.train_dalle` runs
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        torch.manual_seed(SEED)
        vae_path = run_dir / "vae.npz"
        save_vae_checkpoint(str(vae_path), DiscreteVAE(
            image_size=256, num_layers=3, num_tokens=8192, codebook_dim=512, hidden_dim=64))
        encode_err, encode_share = check_vae_encode(torch, vae_path)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
        for label, extra in (("A", ["--epochs", "1", "--set", "log_images_freq=5"]),
                             ("B", ["--epochs", "2", "--resume", "--set", "log_images_freq=0"])):
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            summary = train_dalle.main(trainer_args(run_dir, vae_path, *extra))
            torch.cuda.synchronize()
            summary["wall_s"] = time.perf_counter() - t0
            summary["launches"] = {c.__name__: c.launches for c in counters}
            runs[label] = summary
            if label == "A":
                step_meta, (count,) = _npz_entries(run_dir / "dalle_ckpt" / "step_00000008.npz",
                                                   "opt/0002")
        peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
        a, b = runs["A"], runs["B"]
        final_meta, (final_count,) = _npz_entries(b["out_file"], "opt/0002")
        t0 = time.perf_counter()
        engine = engine_from_checkpoint(b["out_file"], batch_shapes=(1,), device="cuda")
        engine_s = time.perf_counter() - t0
        engine_depth = engine.model.depth
        del engine
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = script_tf32
        shutil.rmtree(run_dir, ignore_errors=True)

    steps = TRAINER_SAMPLES // 4
    attn = 2 * TRAINER_DEPTH * steps
    expect = {
        "A": {"flash_attention_fwd": attn, "flash_attention_bwd": attn,
              "flash_decode_attention": TRAINER_DEPTH * (1 + 1024)},
        "B": {"flash_attention_fwd": attn, "flash_attention_bwd": attn, "flash_decode_attention": 0},
    }
    rate = b["rates"][0] if b["rates"] else {}
    step_ms = b["step_ms"]
    ms_per_step = sum(step_ms) / len(step_ms) if step_ms else float("nan")
    result = dict(
        depth=TRAINER_DEPTH, launches={k: r["launches"] for k, r in runs.items()},
        run_wall_s={k: r["wall_s"] for k, r in runs.items()},
        ms_per_step=ms_per_step, median_ms_per_step=sorted(step_ms)[len(step_ms) // 2] if step_ms else None,
        step_ms={k: r["step_ms"] for k, r in runs.items()},
        sample_per_sec=4e3 / ms_per_step,
        mfu=mfu(4e3 / ms_per_step, b["flops_per_sample"], b["device_name"]),
        input_wait_frac=rate.get("input_wait_frac"),
        meter_sample_per_sec=rate.get("sample_per_sec"), meter_mfu=rate.get("mfu"),
        meter_ms_per_step=1e3 * 4 / rate["sample_per_sec"] if rate else None,
        step_checkpoint_host_s=a["save_s"] + b["save_s"], export_s=a["export_s"] + b["export_s"],
        restore_s=b["load_s"], engine_load_s=engine_s, peak_memory_gib=peak_gib,
        held_by_earlier_phases_gib=held / 2**30,
        losses=b["losses"], last_loss={k: r["last_loss"] for k, r in runs.items()},
        encode_max_abs_err=encode_err, encode_identical_share=encode_share, card=smi,
    )
    print("trainer " + json.dumps(result))
    for label, want in expect.items():
        if runs[label]["launches"] != want:
            fail(f"trainer run {label} launched {runs[label]['launches']}, expected {want}")
    if a["global_step"] != steps or step_meta.get("step") != steps or int(count) != steps:
        fail(f"run A's step checkpoint: step {step_meta.get('step')}, Adam count {count}")
    if (b["resumed_step"], b["resumed_adam_count"]) != (steps, steps) or (
            b["resumed_plateau"] is None or b["resumed_plateau"] != step_meta.get("plateau")):
        fail(f"run B restored step {b['resumed_step']}, Adam count {b['resumed_adam_count']}, "
             f"plateau {b['resumed_plateau']} (checkpoint: {step_meta.get('plateau')})")
    if b["global_step"] != 2 * steps or final_meta["train"]["global_step"] != 2 * steps or (
            int(final_count) != 2 * steps):
        fail(f"run B ended at step {b['global_step']}, Adam count {final_count}")
    if not all(math.isfinite(r["last_loss"]) for r in runs.values()) or not b["losses"]:
        fail(f"trainer losses not finite: {result['last_loss']}, {b['losses']}")
    toks = a.get("sample_tokens")
    if toks is None or toks.shape != (1, 1024) or toks.min() < 0 or toks.max() >= 8192:
        fail("run A took no in-loop sample of 1024 tokens in range")
    if not rate or engine_depth != TRAINER_DEPTH:
        fail(f"run B logged no rate ({rate}) or the export served depth {engine_depth}")
    if [len(r["step_ms"]) for r in runs.values()] != [steps, steps] or not math.isfinite(ms_per_step):
        fail(f"the trainer timed {[len(r['step_ms']) for r in runs.values()]} steps, expected {steps} a run")
    return result


# phase 13: the rest of training
REST_DEPTH = TRAINER_DEPTH  # the flagship width at phase 12's depth cut
REST_SAMPLES = 20  # rainbow:20 at batch 4: 5 steps a RevNet run (the first two warm up)
REST_SCAN_SAMPLES = 8  # the scan run: 2 steps
# an 8k native BPE (the shipped smaller vocabulary) keeps the exports small
REST_VOCAB = "dalle_pytorch_tpu_torch/data/default_bpe_8k.model"
REST_PROMPT = "a red cube on a blue sphere"
REST_ORACLE_POSITIONS = 16  # the greedy decode held to the uncached oracle
# the RevNet's gradients (its custom backward) against autograd through
# the same forward (`revnet_naive`), worst parameter's ||g - g_naive|| /
# ||g_naive|| on one batch. The backward rebuilds each layer's inputs as
# x2 = y2 - g(y1), x1 = y1 - f(x2): one float32 rounding each, where the
# naive run keeps the inputs. In fp32 (the 3xTF32 kernels) that stays at
# the attention kernels' own fp32 level (an H100: 4.8e-7; ATTN_TOL["fp32"]
# is 1e-5 a tile); under bf16 autocast the rebuilt input can round to
# another bf16 value in the recompute's products, one bf16 ulp (2^-8) on a
# few elements (an H100: 2.0e-3). Limits 20x and 10x those
REVNET_GRAD_TOL = {"fp32": 1e-5, "bf16": 2e-2}
# CLIP's scores on the card (float32, no TF32) against its CPU run
CLIP_SCORE_TOL = 1e-4
# the wrappers' scores (logits, negated distances) on the card against
# their CPU runs, relative to the largest |score| of the image; indices
# must agree wherever the CPU run's top-2 gap exceeds twice it (relative).
# Both sides are float32 without TF32; an H100 gave 1.6e-6 for the OpenAI
# logits and 2.7e-5 for the VQGAN's |z|^2 - 2 z.e + |e|^2, whose terms
# cancel to the much smaller gaps between codes
WRAPPER_SCORE_TOL = 1e-4
# decoded pixels (in [0, 1]) absolute; seen 1.2e-7 and 8.6e-6
WRAPPER_DECODE_TOL = 1e-4
# `configs/vqgan_imagenet_f16_16384.yaml` (model.params), as JSON: the
# card's machine has no PyYAML
VQGAN_F16 = dict(
    ddconfig=dict(double_z=False, z_channels=256, resolution=256, in_channels=3, out_ch=3, ch=128,
                  ch_mult=[1, 1, 2, 2, 4], num_res_blocks=2, attn_resolutions=[16], dropout=0.0),
    n_embed=16384, embed_dim=256,
)
# the OpenAI dVAE's released geometry (dall_e's Encoder / Decoder defaults)
OPENAI_RELEASED = dict(n_hid=256, n_init=128, vocab=8192, groups=4, blocks=2)


def rest_trainer_args(run_dir, vae_path, samples, *extra):
    """Phase 13's trainer flags: phase 12's model (the flagship width at
    REST_DEPTH, shift and rotary, bf16 autocast, forward_reverse_partial)
    with the 8k vocabulary, one epoch of rainbow:`samples` at batch 4."""
    return [
        "--device", "cuda", "--image_text_folder", f"rainbow:{samples}",
        "--vae_path", str(vae_path), "--batch_size", "4", "--exp", "r", "--epochs", "1",
        "--set", "model.dim=1024", "--set", f"model.depth={REST_DEPTH}",
        "--set", "model.heads=16", "--set", "model.dim_head=64", "--set", "model.text_seq_len=256",
        "--set", "model.shift_tokens=true", "--set", "model.rotary_emb=true",
        "--set", "native=true", "--set", f"bpe_path={REPO / REST_VOCAB}",
        "--set", f"output_dir={run_dir}", *extra,
    ]


def attention_counters():
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention_fwd, fa.flash_attention_bwd


def run_revnet_trainers(torch, run_dir, vae_path):
    """Phase 13a: the trainer with `model.reversible_impl=revnet`, then the
    same run with `revnet_naive`; each run's flash-attention launches, ms
    a step (CUDA events; the median of the steps after the first two,
    which meet the process's first autotuning and allocations) and peak
    memory above what was held before it."""
    from dalle_pytorch_tpu_torch import train_dalle

    runs = {}
    for impl in ("revnet", "revnet_naive"):
        for c in attention_counters():
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s = train_dalle.main(rest_trainer_args(
            run_dir / impl, vae_path, REST_SAMPLES,
            "--set", "model.reversible=true", "--set", f"model.reversible_impl={impl}"))
        torch.cuda.synchronize()
        runs[impl] = dict(
            wall_s=time.perf_counter() - t0, step_ms=s["step_ms"],
            ms_per_step=sorted(s["step_ms"][2:])[len(s["step_ms"][2:]) // 2],  # median, warm steps
            peak_memory_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
            launches={c.__name__: c.launches for c in attention_counters()},
            last_loss=s["last_loss"], global_step=s["global_step"], out_file=s["out_file"],
        )
    steps = REST_SAMPLES // 4
    per_pass = 2 * REST_DEPTH * steps  # two objectives a step, one call a layer
    want = {"revnet": {"flash_attention_fwd": 2 * per_pass, "flash_attention_bwd": per_pass},
            "revnet_naive": {"flash_attention_fwd": per_pass, "flash_attention_bwd": per_pass}}
    for impl, run in runs.items():
        if run["launches"] != want[impl]:
            fail(f"the {impl} trainer run launched {run['launches']}, expected {want[impl]} "
                 "(the RevNet's forward plus its recompute; one backward a layer and objective)")
        if run["global_step"] != steps or not math.isfinite(run["last_loss"]):
            fail(f"the {impl} run ended at step {run['global_step']}, loss {run['last_loss']}")
    return runs


def kernel_names(torch, fn):
    """The device kernels one call fn() launches, as a torch.profiler trace
    names them ("fwd_wgmma_kernel<64>", ...), with their counts."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            found = re.search(r"\w+_kernel<[^<>]*>|\w+_kernel\b", evt.name)
            name = found.group(0) if found else evt.name[:60]
            names[name] = names.get(name, 0) + 1
    return names


def check_revnet_gradients(torch, export):
    """Phase 13b: on one fixed batch (4 rows, seeded), the RevNet's
    gradients (its custom backward) against `revnet_naive`'s (autograd
    through the same forward), float32 (the 3xTF32 kernels) and bf16
    autocast (the tensor-core kernels); a trace of the bf16 RevNet step
    names the kernels it launched. Returns (the comparison, the trace to
    take after the phase's timed parts)."""
    import numpy as np

    from dalle_pytorch_tpu_torch.training.pipeline import dalle_from_config, load_dalle_checkpoint
    from dalle_pytorch_tpu_torch.training.steps import accumulate_gradients, make_dalle_loss
    from dalle_pytorch_tpu_torch.weights import load_dalle_params

    config, tree, _, _, _ = load_dalle_checkpoint(export, opt=False)
    vocab = tree["text_emb"]["embedding"].shape[0] - config["model"]["text_seq_len"]
    with torch.device("cuda"):
        model, _ = dalle_from_config(config, num_image_tokens=8192, image_fmap_size=32,
                                     vocab_size=vocab)
    load_dalle_params(model, tree)
    rng = np.random.RandomState(SEED)
    text = rng.randint(1, vocab, (4, 256))
    text[:, 40:] = 0
    batch = {"text": torch.tensor(text, device="cuda"),
             "image_tokens": torch.tensor(rng.randint(0, 8192, (4, 1024)), device="cuda")}
    loss_fn = make_dalle_loss(model, "forward_reverse_partial")
    result = {}
    for key, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        grads, losses = {}, {}
        for impl in ("revnet", "revnet_naive"):
            model.transformer.reversible_impl = impl
            metrics = accumulate_gradients(model, loss_fn, batch, autocast_dtype=dtype)
            grads[impl] = [p.grad.float().clone() for p in model.parameters()]
            losses[impl] = metrics["loss"].item()
        rel = [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
               for a, b in zip(grads["revnet"], grads["revnet_naive"])]
        num = sum(((a - b) ** 2).sum() for a, b in zip(grads["revnet"], grads["revnet_naive"]))
        den = sum((b**2).sum() for b in grads["revnet_naive"])
        result[key] = dict(worst_param_rel=max(rel), global_rel=(num / den).sqrt().item(),
                           loss=losses, limit=REVNET_GRAD_TOL[key])
        print(f"check RevNet gradients ({key}) vs revnet_naive: worst parameter relative norm "
              f"{max(rel):.3g} (limit {REVNET_GRAD_TOL[key]}), global {result[key]['global_rel']:.3g}, "
              f"losses {losses}")
        if not max(rel) <= REVNET_GRAD_TOL[key]:
            fail(f"the RevNet's {key} gradients are {max(rel)} from revnet_naive's")
        if losses["revnet"] != losses["revnet_naive"]:
            fail(f"the RevNet's {key} loss {losses} differs from revnet_naive's on the same forward")
    model.transformer.reversible_impl = "revnet"

    def trace():
        """The attention kernels of one bf16 RevNet step, from a
        torch.profiler trace (taken last: a trace slows the launches after
        it): fwd_wgmma_kernel<64> and bwd_mma_kernel, no fp32 kernel."""
        names = kernel_names(torch, lambda: accumulate_gradients(
            model, loss_fn, batch, autocast_dtype=torch.bfloat16))
        attn = {k: v for k, v in names.items() if "mma" in k or "tf32" in k}
        print(f"the bf16 RevNet step's attention kernels (torch.profiler trace): {json.dumps(attn)}")
        if "fwd_wgmma_kernel<64>" not in names or not any(k.startswith("bwd_mma_kernel") for k in names):
            fail(f"the bf16 RevNet step did not launch fwd_wgmma_kernel<64> and bwd_mma_kernel: {attn}")
        if any("tf32" in k for k in names):
            fail(f"the bf16 RevNet step launched fp32 attention kernels: {attn}")
        return attn

    return result, trace


def greedy_positions(torch, model, text_ids, tokens, n):
    """(oracle tokens, top-2 logit gaps) at image positions 0..n-1 of a
    teacher-forced uncached forward over `tokens` [1, image_seq_len]."""
    from dalle_pytorch_tpu_torch.models.dalle import NEG_MASK_VALUE

    dev = model.text_emb.weight.device
    blocked = (torch.arange(model.total_tokens, device=dev) < model.total_text_tokens)[None]
    with torch.inference_mode():
        _, out = model.trunk(torch.tensor(text_ids[None], device=dev), torch.tensor(tokens, device=dev))
        rows = torch.stack([model.to_logits(out[:, model.text_seq_len + p]).float() for p in range(n)], 1)
        rows = rows.masked_fill(blocked[:, None], NEG_MASK_VALUE)
        top2 = rows.topk(2, dim=-1)
    gaps = (top2.values[..., 0] - top2.values[..., 1])[0].cpu().numpy()
    return (top2.indices[..., 0][0] - model.total_text_tokens).cpu().numpy(), gaps


def serve_revnet(torch, export):
    """Phase 13c: the RevNet export through `engine_from_checkpoint`: one
    greedy image (top_k 1.0 keeps one logit) decoded by the two-stream
    cached branch (flash decode once a layer a step, the prefill on the
    tile arm), held to the uncached oracle's greedy tokens on the first
    REST_ORACLE_POSITIONS positions by the margin rule: the oracle is one
    teacher-forced uncached forward over the engine's tokens, so each
    position is compared on the same prefix, and every position whose
    top-2 logit gap is at least ORACLE_MARGIN must agree (random weights
    leave many near-ties: a bf16 logit's step is 2^-6 at these sizes)."""
    from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention
    from dalle_pytorch_tpu_torch.serving.engine import SampleSpec, engine_from_checkpoint

    engine = engine_from_checkpoint(export, batch_shapes=(1,), device="cuda")
    if not (engine.model.transformer.revnet and engine.model.depth == REST_DEPTH):
        fail("the RevNet export did not load as a RevNet")
    text_ids = engine.tokenize(REST_PROMPT)
    flash_decode_attention.launches = flash_decode_attention.tile_launches = 0
    t0 = time.perf_counter()
    toks, pixels = engine.generate([SampleSpec(text_ids, seed=SEED, temperature=1.0, top_k=1.0)])
    wall = time.perf_counter() - t0
    launches = dict(flash_decode=flash_decode_attention.launches,
                    flash_decode_tile=flash_decode_attention.tile_launches)
    oracle, gaps = greedy_positions(torch, engine.model, text_ids, toks, REST_ORACLE_POSITIONS)
    held = 0
    for p in range(REST_ORACLE_POSITIONS):
        if gaps[p] < ORACLE_MARGIN:
            continue
        if oracle[p] != toks[0, p]:
            fail(f"the RevNet's cached decode picked {toks[0, p]} at image position {p}, the "
                 f"uncached oracle {oracle[p]} (top-2 gap {gaps[p]:.3g})")
        held += 1
    summary = dict(generate_s=wall, launches=launches, oracle_positions_held=held,
                   min_gap=float(gaps[:REST_ORACLE_POSITIONS].min()))
    print(f"RevNet serving: {json.dumps(summary)}")
    if launches["flash_decode"] != REST_DEPTH * (1 + engine.image_seq_len):
        fail(f"the RevNet engine launched flash_decode {launches['flash_decode']} times")
    if launches["flash_decode_tile"] != REST_DEPTH:
        fail(f"the RevNet engine's prefill launched the tile arm {launches['flash_decode_tile']} times")
    if held == 0 or pixels.shape != (1, 256, 256, 3) or not math.isfinite(float(pixels.sum())):
        fail(f"the RevNet engine: {held} oracle positions held, pixels {pixels.shape}")
    return summary


def run_scan_trainer(torch, run_dir, vae_path):
    """Phase 13d: a 2-step trainer run with `model.executor=scan` (its
    export in the scan layout, the Adam moments stacked), `--dalle_path`
    resuming it (Adam count 2 read back; the epoch is done, so no step),
    and `engine_from_checkpoint` loading it."""
    from dalle_pytorch_tpu_torch import train_dalle
    from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint

    for c in attention_counters():
        c.launches = 0
    first = train_dalle.main(rest_trainer_args(run_dir / "scan", vae_path, REST_SCAN_SAMPLES,
                                               "--set", "model.executor=scan"))
    launches = {c.__name__: c.launches for c in attention_counters()}
    again = train_dalle.main(rest_trainer_args(run_dir / "scan_resumed", vae_path, REST_SCAN_SAMPLES,
                                               "--dalle_path", first["out_file"]))
    meta, (count, stacked) = _npz_entries(
        again["out_file"], "opt/0002", "dalle/transformer/scan_stack/layers/attn/to_qkv/kernel")
    engine = engine_from_checkpoint(again["out_file"], batch_shapes=(1,), device="cuda")
    steps = REST_SCAN_SAMPLES // 4
    summary = dict(launches=launches, resumed_adam_count=int(count), stacked_shape=list(stacked.shape),
                   executor=meta["config"]["model"]["executor"], served_depth=engine.model.depth)
    print(f"scan layout: {json.dumps(summary)}")
    del engine
    want = 2 * REST_DEPTH * steps
    if launches != {"flash_attention_fwd": want, "flash_attention_bwd": want}:
        fail(f"the scan run launched {launches}, expected {want} each")
    if int(count) != steps or again["global_step"] != steps or summary["executor"] != "scan":
        fail(f"the scan export resumed with Adam count {count} at step {again['global_step']}")
    if stacked.shape[0] != REST_DEPTH or summary["served_depth"] != REST_DEPTH:
        fail(f"the scan export's stacked kernel {stacked.shape}, served depth {summary['served_depth']}")
    return summary


def run_vae_clip_trainers(torch, run_dir):
    """Phase 13e: `train_vae` at 256 px (8192 codes, straight-through with
    ReinMax) for 2 steps, its export's encode on the card held to its CPU
    run (`check_vae_encode`); `train_clip` at its defaults (dim 256, depth
    4, 128 px, batch 64, the default vocabulary) for 2 steps, its export's
    scores on the card held to its CPU run on 8 seeded pairs."""
    import numpy as np

    from dalle_pytorch_tpu_torch import train_clip, train_vae
    from dalle_pytorch_tpu_torch.models.clip import clip_scores
    from dalle_pytorch_tpu_torch.training.pipeline import load_clip_checkpoint

    vae_out = run_dir / "vae_trained.npz"
    t0 = time.perf_counter()
    sv = train_vae.main(["--device", "cuda", "--image_folder", "rainbow:8", "--batch_size", "4",
                         "--epochs", "1", "--output", str(vae_out), "--set", f"output_dir={run_dir}",
                         "--set", "vae.image_size=256", "--set", "vae.straight_through=true",
                         "--set", "vae.reinmax=true"])
    vae_s = time.perf_counter() - t0
    if sv["global_step"] != 2 or not math.isfinite(sv["last_loss"]):
        fail(f"train_vae ended at step {sv['global_step']}, loss {sv['last_loss']}")
    encode_err, encode_share = check_vae_encode(torch, vae_out)

    clip_out = run_dir / "clip.npz"
    t0 = time.perf_counter()
    sc = train_clip.main(["--device", "cuda", "--image_text_folder", "rainbow:128",
                          "--output", str(clip_out), "--epochs", "1"])
    clip_s = time.perf_counter() - t0
    if sc["global_step"] != 2 or not math.isfinite(sc["last_loss"]):
        fail(f"train_clip ended at step {sc['global_step']}, loss {sc['last_loss']}")
    clip = load_clip_checkpoint(str(clip_out))
    rng = np.random.RandomState(SEED)
    text = torch.tensor(rng.randint(1, clip.num_text_tokens, (8, clip.text_seq_len)))
    images = torch.tensor(rng.rand(8, 128, 128, 3).astype(np.float32))
    ref = clip_scores(clip, text, images)
    got = clip_scores(clip.cuda(), text.cuda(), images.cuda()).cpu()
    clip_err = (got - ref).abs().max().item()
    summary = dict(vae_wall_s=vae_s, vae_step_ms=sv["step_ms"], vae_loss=sv["last_loss"],
                   vae_encode_max_abs_err=encode_err, vae_encode_identical_share=encode_share,
                   clip_wall_s=clip_s, clip_step_ms=sc["step_ms"], clip_loss=sc["last_loss"],
                   clip_score_max_abs_err=clip_err)
    print(f"dVAE and CLIP trainers: {json.dumps(summary)}")
    if not clip_err <= CLIP_SCORE_TOL:
        fail(f"the trained CLIP's scores on the card are {clip_err} from its CPU run")
    return summary


def openai_vae_states(torch, n_hid, n_init, vocab, groups, blocks, device, channels=3):
    """Seeded state dicts (encoder, decoder) in the dall_e package's layout
    (`.w` / `.b` convs in `blocks.group_g.block_i`), its widths: encoder
    groups n_hid x (1, 2, 4, ...), decoder n_hid x (..., 4, 2, 1) after an
    input 1x1 conv from the codes to n_init channels."""
    g = torch.Generator(device=device).manual_seed(SEED)
    enc, dec = {}, {}

    def conv(state, key, n_in, n_out, kw):
        state[f"{key}.w"] = torch.randn(n_out, n_in, kw, kw, generator=g, device=device) / math.sqrt(n_in * kw * kw)
        state[f"{key}.b"] = 0.01 * torch.randn(n_out, generator=g, device=device)

    def block(state, key, n_in, n_out, kernels):
        hid = n_out // 4
        if n_in != n_out:
            conv(state, f"{key}.id_path", n_in, n_out, 1)
        for i, (a, b, kw) in enumerate(zip((n_in, hid, hid, hid), (hid, hid, hid, n_out), kernels), 1):
            conv(state, f"{key}.res_path.conv_{i}", a, b, kw)

    for state, widths, first, kernels, n_out in (
        (enc, [1] + [2 ** (i - 1) for i in range(1, groups + 1)], channels, (3, 3, 3, 1), vocab),
        (dec, [2 ** (groups - 1)] + [2 ** (groups - i) for i in range(1, groups + 1)], vocab,
         (1, 3, 3, 3), 2 * channels),
    ):
        width0 = widths[1] * n_hid if state is enc else n_init
        conv(state, "blocks.input", first, width0, 7 if state is enc else 1)
        for gi in range(1, groups + 1):
            for bi in range(1, blocks + 1):
                n_in = width0 if (gi == 1 and bi == 1) else widths[gi if bi > 1 else gi - 1] * n_hid
                block(state, f"blocks.group_{gi}.block_{bi}", n_in, widths[gi] * n_hid, kernels)
        conv(state, "blocks.output.conv", widths[groups] * n_hid, n_out, 1)
    return enc, dec


def vqgan_state(torch, dd, n_embed, embed_dim, device):
    """A seeded state dict in taming's VQModel layout for `dd` (the
    ddconfig): GroupNorms at identity, convs scaled by their fan-in."""
    g = torch.Generator(device=device).manual_seed(SEED)
    state = {}

    def conv(key, n_in, n_out, k):
        state[f"{key}.weight"] = torch.randn(n_out, n_in, k, k, generator=g, device=device) / math.sqrt(n_in * k * k)
        state[f"{key}.bias"] = 0.01 * torch.randn(n_out, generator=g, device=device)

    def norm(key, c):
        state[f"{key}.weight"] = torch.ones(c, device=device)
        state[f"{key}.bias"] = torch.zeros(c, device=device)

    def resnet(key, cin, cout):
        norm(f"{key}.norm1", cin)
        conv(f"{key}.conv1", cin, cout, 3)
        norm(f"{key}.norm2", cout)
        conv(f"{key}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{key}.nin_shortcut", cin, cout, 1)

    def attn(key, c):
        norm(f"{key}.norm", c)
        for name in ("q", "k", "v", "proj_out"):
            conv(f"{key}.{name}", c, c, 1)

    ch, chans, nres, z = dd["ch"], [dd["ch"] * m for m in dd["ch_mult"]], dd["num_res_blocks"], dd["z_channels"]
    conv("encoder.conv_in", dd["in_channels"], ch, 3)
    cin, res = ch, dd["resolution"]
    for i, cout in enumerate(chans):
        for j in range(nres):
            resnet(f"encoder.down.{i}.block.{j}", cin if j == 0 else cout, cout)
        if res in dd["attn_resolutions"]:
            for j in range(nres):
                attn(f"encoder.down.{i}.attn.{j}", cout)
        if i != len(chans) - 1:
            conv(f"encoder.down.{i}.downsample.conv", cout, cout, 3)
            res //= 2
        cin = cout
    for name in ("encoder.mid.block_1", "encoder.mid.block_2"):
        resnet(name, cin, cin)
    attn("encoder.mid.attn_1", cin)
    norm("encoder.norm_out", cin)
    conv("encoder.conv_out", cin, 2 * z if dd.get("double_z") else z, 3)
    conv("quant_conv", z, embed_dim, 1)
    state["quantize.embedding.weight"] = torch.randn(n_embed, embed_dim, generator=g, device=device)
    conv("post_quant_conv", embed_dim, z, 1)
    conv("decoder.conv_in", z, chans[-1], 3)
    for name in ("decoder.mid.block_1", "decoder.mid.block_2"):
        resnet(name, chans[-1], chans[-1])
    attn("decoder.mid.attn_1", chans[-1])
    cin, res = chans[-1], dd["resolution"] // 2 ** (len(chans) - 1)
    for i in reversed(range(len(chans))):
        cout = chans[i]
        for j in range(nres + 1):
            resnet(f"decoder.up.{i}.block.{j}", cin if j == 0 else cout, cout)
        if res in dd["attn_resolutions"]:
            for j in range(nres + 1):
                attn(f"decoder.up.{i}.attn.{j}", cout)
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", cout, cout, 3)
            res *= 2
        cin = cout
    norm("decoder.norm_out", chans[0])
    conv("decoder.conv_out", chans[0], dd["out_ch"], 3)
    return state


def hold_wrapper(torch, label, cpu_vae, images):
    """A wrapper on the card against its CPU run on `images`: scores within
    WRAPPER_SCORE_TOL of the largest |score| (relative), indices identical
    wherever the CPU run's top-2 gap exceeds twice that, and the decode of
    the CPU run's indices within WRAPPER_DECODE_TOL (both in full float32)."""
    import copy

    from dalle_pytorch_tpu_torch.models.dvae import exact_float32

    card = copy.deepcopy(cpu_vae).cuda()
    with torch.no_grad():
        ref = cpu_vae.encode_scores(images)
        got = card.encode_scores(images.cuda()).cpu()
        scale = ref.abs().amax(dim=-1, keepdim=True)
        err = ((got - ref).abs() / scale).max().item()
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * WRAPPER_SCORE_TOL * scale[..., 0]
        idx = ref.argmax(-1)
        same = got.argmax(-1) == idx
        pixels = cpu_vae.decode(idx)
        with exact_float32():
            card_pixels = card.decode(idx.cuda()).cpu()
    decode_err = (card_pixels - pixels).abs().max().item()
    out = dict(score_rel_err=err, identical_share=same.float().mean().item(),
               clear_share=clear.float().mean().item(), decode_max_abs_err=decode_err,
               geometry=[cpu_vae.image_size, cpu_vae.num_layers, cpu_vae.num_tokens])
    print(f"{label} on the card vs CPU: {json.dumps(out)}")
    if not err <= WRAPPER_SCORE_TOL or not bool(same[clear].all()):
        fail(f"{label}: scores {err} from the CPU run, or another index where the gap is clear")
    if not decode_err <= WRAPPER_DECODE_TOL or tuple(card_pixels.shape[1:]) != (256, 256, 3):
        fail(f"{label}: decode {decode_err} from the CPU run, shape {tuple(card_pixels.shape)}")
    return out


def check_pretrained_wrappers(torch, run_dir):
    """Phase 13f: synthetic checkpoints at the released geometries (no
    released weights are here): the OpenAI dVAE's pickles (256 px, f/8,
    8192 codes) and a VQGAN from `configs/vqgan_imagenet_f16_16384.yaml`'s
    ddconfig (f/16, 16384 codes) with its config written as JSON; each
    wrapper held to its CPU run on one rainbow image."""
    import numpy as np

    from dalle_pytorch_tpu_torch.data.rainbow import RainbowDataset
    from dalle_pytorch_tpu_torch.models.vae_io import OpenAIDiscreteVAE, VQGanVAE

    image = torch.from_numpy(np.stack([RainbowDataset(num_samples=4, image_size=256).image(1)]))
    openai_dir = run_dir / "openai"
    openai_dir.mkdir()
    enc, dec = openai_vae_states(torch, device="cuda", **OPENAI_RELEASED)
    torch.save({k: v.cpu() for k, v in enc.items()}, openai_dir / "encoder.pkl")
    torch.save({k: v.cpu() for k, v in dec.items()}, openai_dir / "decoder.pkl")
    del enc, dec
    openai = OpenAIDiscreteVAE(openai_dir)
    if (openai.num_tokens, openai.num_layers, openai.fmap_size) != (8192, 3, 32):
        fail(f"the OpenAI wrapper read {openai.num_tokens} codes, {openai.num_layers} layers")
    result = {"openai": hold_wrapper(torch, "OpenAI dVAE", openai, image)}
    del openai

    state = vqgan_state(torch, VQGAN_F16["ddconfig"], VQGAN_F16["n_embed"], VQGAN_F16["embed_dim"], "cuda")
    torch.save({"state_dict": {k: v.cpu() for k, v in state.items()}}, run_dir / "vqgan.ckpt")
    del state
    config = {"model": {"target": "taming.models.vqgan.VQModel", "params": VQGAN_F16}}
    (run_dir / "vqgan.json").write_text(json.dumps(config))
    vqgan = VQGanVAE(str(run_dir / "vqgan.ckpt"), str(run_dir / "vqgan.json"))
    if (vqgan.num_tokens, vqgan.num_layers, vqgan.fmap_size) != (16384, 4, 16):
        fail(f"the VQGAN wrapper read {vqgan.num_tokens} codes, {vqgan.num_layers} layers")
    result["vqgan"] = hold_wrapper(torch, "VQGAN f/16", vqgan, image)
    return result


def run_rest_of_training(torch, smi):
    """Phase 13: (a) RevNet training through the trainer twin and its
    revnet_naive twin run, (b) the RevNet's gradients against
    revnet_naive's on the card with the kernels traced, (c) the RevNet
    export served, (d) the scan layout trained, resumed and loaded, (e)
    the dVAE and CLIP trainers, (f) the pretrained VAE wrappers. Under
    torch's default precision settings (as the CLIs run) for (a), (d) and
    (e); the run directory is removed at the end. Returns the summary,
    with each part's wall."""
    import shutil

    from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
    from dalle_pytorch_tpu_torch.training.pipeline import save_vae_checkpoint

    run_dir = REPO / "build" / "chip_smoke" / "rest"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    script_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    walls, result = {}, {"card": smi}
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        torch.manual_seed(SEED)
        vae_path = run_dir / "vae.npz"
        save_vae_checkpoint(str(vae_path), DiscreteVAE(
            image_size=256, num_layers=3, num_tokens=8192, codebook_dim=512, hidden_dim=64))
        t0 = time.perf_counter()
        result["revnet_runs"] = run_revnet_trainers(torch, run_dir, vae_path)
        walls["a_revnet_trainers"] = time.perf_counter() - t0
        export = result["revnet_runs"]["revnet"]["out_file"]
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = script_tf32
        t0 = time.perf_counter()
        result["revnet_gradients"], trace = check_revnet_gradients(torch, export)
        walls["b_revnet_gradients"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["revnet_serving"] = serve_revnet(torch, export)
        walls["c_revnet_serving"] = time.perf_counter() - t0
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        t0 = time.perf_counter()
        result["scan"] = run_scan_trainer(torch, run_dir, vae_path)
        walls["d_scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["vae_clip"] = run_vae_clip_trainers(torch, run_dir)
        walls["e_vae_clip"] = time.perf_counter() - t0
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = script_tf32
        t0 = time.perf_counter()
        result["wrappers"] = check_pretrained_wrappers(torch, run_dir)
        walls["f_wrappers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["revnet_gradients"]["bf16_trace"] = trace()
        walls["b_trace"] = time.perf_counter() - t0
        del trace
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = script_tf32
        shutil.rmtree(run_dir, ignore_errors=True)
    result["walls"] = walls
    runs = result["revnet_runs"]
    print("rest of training " + json.dumps({
        "revnet_ms_per_step": {k: r["ms_per_step"] for k, r in runs.items()},
        "revnet_peak_memory_gib": {k: r["peak_memory_gib"] for k, r in runs.items()},
        "revnet_step_ms": {k: r["step_ms"] for k, r in runs.items()},
        "revnet_launches": {k: r["launches"] for k, r in runs.items()},
        "walls": walls, "card": smi,
    }))
    return result


# --------------------------------------------------------------- phase 14
# tensor-parallel serving at the flagship width, depth SHORT_DEPTH, both
# shards on the one card (cuda:0 named twice): every kernel launches at the
# split head count
TP = 2
TP_CASES = {"step": (1, [258, 700, 1024, 1281]), "prefill": (257, [257] * 4), "resume": (1280, [1280] * 4)}
TP_ADMIT_AFTER = 8  # chunks before the second admission
TP_RESUME_AFTER = 64  # chunks before the paged run preempts slot 1 and resumes it
# the bf16 logit tolerance at tp > 1: the first-position logits of the
# shards' row-parallel sums against the unsharded product (the same bound
# phase 10 holds a resume's logits to); tokens are held by the margin rule,
# ORACLE_MARGIN (twice this) the gap under which a flip is allowed
TP_LOGIT_TOL = RESUME_LOGIT_TOL
TP_TIMED_ITERS = 48


def tp_kernel_cases(torch, shape, int8):
    """{row name: (fn, plain fn, args at H = 16, split-head dim of each arg
    or None, sharded)} of kernels 1 and 3-5 (int8 K/V with `int8`: kernel 2
    is kernel 1's int8 arm) at one of TP_CASES's shapes; `sharded(parts)`
    runs the head-split wrapper the serving path calls
    (`sharded_flash_decode_attention`, `sharded_paged_decode_attention`
    with the paged kernel, a page bitmap as blocks of one page) on the
    shards' argument tuples, each argument given one per shard."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    n, lengths = TP_CASES[shape]
    q, k, v, lens = flash_inputs(torch, n, lengths, torch.bfloat16)[0]
    bitmap = torch.ones((q.shape[0], -(-MAIN["cache"] // 128)), dtype=torch.int32, device="cuda")
    bitmap[:, 1::3] = 0  # every third 128-key block dead, block 0 alive
    pq, pk, pv, plens, table, _ = paged_case(torch, q.shape[0], q.shape[1], n, q.shape[3], PAGE, lengths,
                                             torch.bfloat16, MAIN["cache"], SEED + 14)
    page_bm = torch.ones(table.shape, dtype=torch.int32, device="cuda")
    page_bm[:, 2::5] = 0
    sc = pscale = ()
    if int8:
        k, v, *sc = quantized(torch, k, v)
        pk, pv, *pscale = quantized(torch, pk, pv)
    heads, kv = 1, (1, 1)
    vlen = table.shape[1] * PAGE

    def each(parts, i):
        return [p[i] for p in parts] if len(parts[0]) > i else None

    def flash(parts, bm=None):
        scales = len(parts[0]) - (5 if bm else 4)
        return fd.sharded_flash_decode_attention(
            *(each(parts, i) for i in range(4)), *(each(parts, len(parts[0]) - scales + j) for j in range(scales)),
            block_bitmap=each(parts, 4) if bm else None, sparse_block=128 if bm else None)

    def paged(parts, bm=None):
        scales = len(parts[0]) - (6 if bm else 5)
        return fd.sharded_paged_decode_attention(
            *(each(parts, i) for i in range(5)), vlen, "kernel",
            *(each(parts, len(parts[0]) - scales + j) for j in range(scales)),
            block_bitmap=each(parts, 5) if bm else None, sparse_block=PAGE if bm else None)

    return {
        "flash_decode": (fd.flash_decode_attention, fd.flash_decode_attention_plain,
                         (q, k, v, lens, *sc), (heads, *kv, None) + (1,) * len(sc), flash),
        "block_sparse_flash_decode": (
            lambda *a: fd.block_sparse_flash_decode_attention(*a[:5], 128, *a[5:]),
            lambda *a: fd.block_sparse_flash_decode_attention_plain(*a[:5], 128, *a[5:]),
            (q, k, v, lens, bitmap, *sc), (heads, *kv, None, None) + (1,) * len(sc),
            lambda parts: flash(parts, bm=True)),
        "paged_flash_decode": (fd.paged_flash_decode_attention, fd.paged_flash_decode_attention_plain,
                               (pq, pk, pv, plens, table, *pscale), (heads, *kv, None, None) + (1,) * len(pscale),
                               paged),
        "block_sparse_paged_flash_decode": (
            fd.block_sparse_paged_flash_decode_attention, fd.block_sparse_paged_flash_decode_attention_plain,
            (pq, pk, pv, plens, table, page_bm, *pscale), (heads, *kv, None, None, None) + (1,) * len(pscale),
            lambda parts: paged(parts, bm=True)),
    }


def tp_shard_args(args, dims, s):
    """Shard s's arguments: its half of the heads of each split one."""
    return tuple(a if d is None else a.chunk(TP, d)[s].contiguous() for a, d in zip(args, dims))


def check_head_split(torch):
    """Phase 14a: kernels 1-5 (bf16 and int8 K/V) at the step, the prefill
    and the resume shapes: the two shards' launches at H = 8, made by the
    head-split wrappers (`sharded_flash_decode_attention`,
    `sharded_paged_decode_attention`) on per-shard lists of arguments,
    joined by head must be `torch.equal` to the H = 16 launch, and each
    shard within decode_tol of its plain version. Queues the device time of an H = 8 and an H = 16
    launch of kernels 1 and 4 at the step. Returns ({kernel: worst
    max_abs_err}, {kernel: {"h16": row, "h8": row}})."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    worst, timed, failures = {}, {}, []
    for shape in TP_CASES:
        for int8 in (False, True):
            for name, (fn, plain, args, dims, sharded) in tp_kernel_cases(torch, shape, int8).items():
                label = name + ("_int8" if int8 else "")
                whole = fn(*args)
                parts = [tp_shard_args(args, dims, s) for s in range(TP)]
                outs = sharded(parts)
                joined = torch.cat(outs, dim=1)
                same = torch.equal(joined, whole)
                errs = []
                for p, o in zip(parts, outs):
                    ref = plain(*p)
                    errs.append(((o.float() - ref.float()).abs().max().item(), decode_tol(torch, ref, torch.bfloat16)))
                    del ref
                ok = same and all(e <= t for e, t in errs) and bool(torch.isfinite(joined).all())
                print(f"check tp{TP} {label} {shape} n={args[0].shape[2]}: shards at H = {outs[0].shape[1]} joined "
                      f"by head torch.equal to the H = {whole.shape[1]} launch {same}; per shard max_abs_err vs "
                      f"plain " + ", ".join(f"{e:.3e}" for e, _ in errs) + f" (tol {errs[0][1]:.3e})")
                if not ok:
                    failures.append(f"{label} {shape}: equal {same}, errs {errs}")
                worst[label] = max([worst.get(label, 0.0)] + [e for e, _ in errs])
                if shape == "step" and not int8 and name in ("flash_decode", "paged_flash_decode"):
                    rows = {"h16": {}, "h8": {}}
                    for key, a in (("h16", args), ("h8", parts[0])):
                        rows[key]["ms"] = time_ms(torch, fn, [a], TP_TIMED_ITERS)
                        defer_device_time(rows[key], fn, [a], TP_TIMED_ITERS)
                    timed[name] = rows
                del whole, parts, outs, joined
    torch.cuda.synchronize()
    if failures:
        fail("head split: " + "; ".join(failures))
    return worst, timed


def tp_pending(engine):
    """An engine's pending logits [S, V] (over its shards, gathered)."""
    return engine.tp_model.gather_logits([st["row"] for st in engine._state["shards"]])


def tp_serve(torch, engine, specs, hit=False, resume=False):
    """Phase 14, one run driven slot by slot: specs 0 and 1 in one wave;
    after TP_ADMIT_AFTER chunks spec 2 and, in a second wave, spec 3 (or
    with `hit` a repeat of spec 0, a full-prompt prefix-cache hit); with
    `resume`, slot 1 preempted after TP_RESUME_AFTER chunks and resumed at
    its position (one resume dispatch); then chunks until every row is
    done. Returns (tokens [4, 1024] by slot, the spec index of each slot,
    the first wave's pending logits [2, V], {"wall_s", "resumed_at"})."""
    import numpy as np

    from dalle_pytorch_tpu_torch.serving.engine import SampleSpec

    seq = engine.image_seq_len
    t0 = time.perf_counter()
    engine.prefill_slots([(0, specs[0]), (1, specs[1])])
    first = tp_pending(engine)[:2].float().cpu()
    order = [0, 1, 2, 0 if hit else 3]
    done = resumed_at = None
    for chunk in range(1, 10**4):
        pos, act = engine.step_chunk()
        if chunk == TP_ADMIT_AFTER:
            engine.prefill_slots([(2, specs[2]), (3, specs[order[3]])])
            pos, act = engine.chunk_snapshot()
        if resume and chunk == TP_RESUME_AFTER:
            k = int(pos[1])
            prefix = engine.snapshot_rows([1])[0][:k].copy()
            engine.release([1])
            s = specs[1]
            engine.resume_slots([(1, SampleSpec(s.text_ids, seed=s.seed, temperature=s.temperature, top_k=s.top_k,
                                                resume_tokens=prefix, resume_pos=k))])
            resumed_at = k
            pos, act = engine.chunk_snapshot()
        if chunk > TP_ADMIT_AFTER and act.all() and (pos >= seq).all():
            done = chunk
            break
    if done is None:
        fail("a tensor-parallel run never finished")
    toks = engine.harvest([0, 1, 2, 3])
    engine.release([0, 1, 2, 3])
    return toks, order, first, dict(wall_s=time.perf_counter() - t0, resumed_at=resumed_at)


def tp_counting(fd):
    """(the (kernel, H) of every counted launch from now on, undo): wraps
    the decode wrappers' counter."""
    seen = []
    count = fd._count

    def counting(fn, q, k_scale):
        seen.append((fn.__name__, int(q.shape[1])))
        count(fn, q, k_scale)

    fd._count = counting
    return seen, lambda: setattr(fd, "_count", count)


def tp_run(torch, label, make, specs, reference, margins, tp, **drive):
    """One phase-14 engine run: `make()` builds the engine (warmed up
    here), the decode counters are read from zero around `tp_serve`.
    tp = 1: tokens bit-identical to `reference` (the unsharded depth-2
    run's); tp = 2: each row equal to its reference row up to its first
    position whose noised-score margin in the unsharded run is under
    ORACLE_MARGIN (`margin_rule`), every counted launch at H = 8 and each
    kernel's count twice the unsharded run's for this run's chunks and
    dispatches. Returns the run's record."""
    import numpy as np

    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    engine = make()
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    for fn, attr in DECODE_COUNTERS.values():
        setattr(getattr(fd, fn), attr, 0)
        setattr(getattr(fd, fn), "tile_" + attr, 0)
    seen, undo = tp_counting(fd)
    try:
        toks, order, first, info = tp_serve(torch, engine, specs, **drive)
    finally:
        undo()
    launches = {name: getattr(getattr(fd, fn), attr) for name, (fn, attr) in DECODE_COUNTERS.items()}
    launches = {k: n for k, n in launches.items() if n}
    tile = fd.flash_decode_attention.tile_launches
    ref = np.stack([reference[i] for i in order])
    depth, chunks, waves = engine.model.depth, engine.stats.chunks, engine.stats.prefill_dispatches
    step_kernel = "paged_flash_decode" if hasattr(engine, "kv") and engine.paged_decode_impl == "kernel" else "flash_decode"
    unsharded = {step_kernel: depth * CONTINUOUS["chunk_tokens"] * chunks}
    unsharded["flash_decode"] = unsharded.get("flash_decode", 0) + depth * waves
    expected = {k: tp * n for k, n in unsharded.items()}
    heads = sorted({h for _, h in seen})
    record = dict(run=label, tp=tp, wall_s=info["wall_s"], warmup_s=warm_s, chunks=chunks, dispatches=waves,
                  ms_per_chunk=1e3 * info["wall_s"] / chunks, launches=launches, tile_launches=tile,
                  unsharded_launches=unsharded, expected_launches=expected, heads_launched=heads,
                  resumed_at=info["resumed_at"], kv_bytes_per_slot=engine.kv_bytes_per_slot())
    bad = []
    if launches != expected or tile != tp * depth * waves:
        bad.append(f"launches {launches} (tile {tile}), expected {expected} (tile {tp * depth * waves})")
    if heads != [FLAGSHIP["heads"] // tp]:
        bad.append(f"launches at H = {heads}, expected {FLAGSHIP['heads'] // tp}")
    if tp == 1:
        same = np.array_equal(toks, ref)
        record["tokens_identical"] = same
        if not same:
            bad.append(f"tokens differ from the unsharded run's (agreement {(toks == ref).mean():.6f})")
    else:
        rows = []
        for r, i in enumerate(order):
            ok, first_diff, first_low = margin_rule(margins, i, toks[r], reference, 0)
            rows.append(dict(slot=r, spec=i, ok=ok, first_divergence=first_diff, first_low_margin=first_low,
                             low_margin_positions=int((margins[i] < ORACLE_MARGIN).sum())))
            if not ok:
                bad.append(f"slot {r}: first divergence {first_diff} before the first low margin {first_low}")
        record["rows"] = rows
        record["agreement"] = float((toks == ref).mean())
    record["first_logits"] = first
    print(f"tp run {label}: " + json.dumps({k: v for k, v in record.items() if k != "first_logits"}))
    if toks.shape != (4, 1024) or toks.min() < 0 or toks.max() >= FLAGSHIP["num_image_tokens"]:
        bad.append(f"tokens out of range or shape {toks.shape}")
    if hasattr(engine, "kv") and engine.kv.leak_check():
        bad.append(f"leak_check {engine.kv.leak_check()}")
    if bad:
        fail(f"tensor-parallel run {label}: " + "; ".join(bad))
    return record


def start_mesh_servers(torch, vae):
    """Phase 14c, started first: a depth-SHORT_DEPTH flagship-width
    checkpoint of the default vocabulary written, then two processes of
    `python -m dalle_pytorch_tpu_torch.serve --engine continuous`, one
    with `--mesh tp=1` (it loads and warms up while the engine runs of
    phase 14b go on) and one with `--mesh tp=2`, which on this one-card
    machine must exit with the "needs 2 devices" error before it loads
    the checkpoint. Returns the two processes."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.training.pipeline import dalle_config, dvae_hparams, save_dalle_checkpoint
    from dalle_pytorch_tpu_torch.weights import export_dvae_params

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "dalle_tp.npz"
    torch.manual_seed(SEED + 14)
    with torch.device("cuda"):
        model = DALLE(**{**FLAGSHIP, "depth": SHORT_DEPTH, "num_text_tokens": default_vocab()}).to(torch.bfloat16)
    save_dalle_checkpoint(str(path), dalle_config(model, bf16=True), model, vae_params=export_dvae_params(vae),
                          vae_hparams=dvae_hparams(vae))
    del model
    cmd = [sys.executable, "-m", "dalle_pytorch_tpu_torch.serve", "--dalle_path", str(path), "--engine",
           "continuous", "--batch_shapes", "4", "--port", "0", "--preview_every", "0", "--no_resume"]
    one = subprocess.Popen(cmd + ["--mesh", "tp=1"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, start_new_session=True)
    two = subprocess.Popen(cmd + ["--mesh", "tp=2"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, start_new_session=True)
    CHILDREN.extend((one, two))
    return one, two


def stop_process(proc):
    """Kill what is left of `proc`'s process group and reap it."""
    kill_group(proc)
    proc.wait(timeout=30)
    CHILDREN.remove(proc)


def finish_mesh_servers(torch, one, two, t_start):
    """Phase 14c's checks: the tp = 1 server answers one request over HTTP
    (200, the grid's 1024 tokens, a PNG) and its /healthz carries the mesh
    block, then drains on SIGTERM and exits 0; the tp = 2 one exited
    nonzero with "needs 2 devices" and never listened. Returns the
    record."""
    import base64
    import signal

    out = {}
    lines, port = [], None
    while True:
        line = one.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "listening on" in line:
            port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
            break
    if port is None:
        fail("serve --mesh tp=1 did not start:\n" + "".join(lines[-30:]))
    out["ready_s_after_start"] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    status, _, body = http_call(port, "POST", "/generate", {"prompt": "a red cube", "seed": 7})
    out["request_s"] = time.perf_counter() - t0
    hstatus, _, health = http_call(port, "GET", "/healthz")
    png = base64.b64decode(body["images_png_b64"][0]) if status == 200 else b""
    out.update(status=status, healthz=hstatus, mesh=health.get("mesh"),
               tokens=len(body["tokens"][0]) if status == 200 else None, png_bytes=len(png))
    one.send_signal(signal.SIGTERM)
    one.communicate(timeout=120)
    out["exit"] = one.returncode
    print("serve --mesh tp=1 " + json.dumps(out))
    if (status, hstatus, out["exit"]) != (200, 200, 0) or out["tokens"] != 1024 or not png.startswith(b"\x89PNG"):
        fail(f"serve --mesh tp=1: {out}")
    if not out["mesh"] or out["mesh"]["axes"]["tp"] != 1 or out["mesh"]["devices"] != 1:
        fail(f"serve --mesh tp=1: /healthz mesh block {out['mesh']}")
    stdout, stderr = two.communicate(timeout=300)
    needs = "needs 2 devices" in stderr
    print(f"serve --mesh tp=2 on {torch.cuda.device_count()} card: exit {two.returncode}, 'needs 2 devices' in its "
          f"error {needs}: {stderr.strip().splitlines()[-1:]}")
    if two.returncode == 0 or not needs or "listening on" in stdout:
        fail(f"serve --mesh tp=2 on one card: exit {two.returncode}\n{stderr[-2000:]}")
    out["tp2_exit"] = two.returncode
    return out


def run_tensor_parallel(torch, model, vae, specs, reference, smi):
    """Phase 14: tensor-parallel serving on the card. (c) first: the two
    `serve.py --mesh` processes start (`start_mesh_servers`); (a) the head
    split of kernels 1-5 (`check_head_split`); (b) at the flagship width on
    the model's first SHORT_DEPTH layers, `reference` being phase 7's
    causal run of that model: a tp = 1 `ShardedContinuousEngine` and
    `ShardedPagedContinuousEngine` (the paged kernel) on cuda:0, tokens
    bit-identical to `reference`; the same at tp = 2 on devices [cuda:0,
    cuda:0] (the paged run with a prefix-cache hit and a resume), tokens by
    the margin rule, first-position logits within TP_LOGIT_TOL of the
    unsharded model's, launches twice the unsharded run's, at H = 8; then
    (c)'s checks (`finish_mesh_servers`). Returns the phase's record."""
    import numpy as np

    from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
    from dalle_pytorch_tpu_torch.models.dalle import init_decode_cache
    from dalle_pytorch_tpu_torch.serving.sharded import ShardedContinuousEngine, ShardedPagedContinuousEngine

    walls = {}
    t_start = time.perf_counter()
    one, two = start_mesh_servers(torch, vae)
    walls["checkpoint written"] = time.perf_counter() - t_start
    try:
        t0 = time.perf_counter()
        errs, timed = check_head_split(torch)
        walls["head_split"] = time.perf_counter() - t0
        short = first_layers(torch, model, SHORT_DEPTH)
        margins = noised_margins(torch, short, specs, reference)
        texts = torch.tensor(np.stack([specs[i].text_ids for i in (0, 1, 0, 0)]), device="cuda")
        with torch.inference_mode():
            unsharded_first, _ = short.decode_prefill(texts, init_decode_cache(short, 4))
        unsharded_first = unsharded_first[:2].float().cpu()
        kw = dict(**CONTINUOUS, tokenizer=ByteTokenizer(), device="cuda")
        paged_kw = dict(page_size=PAGE, paged_decode_impl="kernel")
        runs = {}
        for tp in (1, TP):
            mesh = {"tp": 1} if tp == 1 else build_mesh(["cuda:0"] * tp)
            for layout, make in (
                ("slot", lambda: ShardedContinuousEngine(short, vae, mesh=mesh, **kw)),
                ("paged", lambda: ShardedPagedContinuousEngine(short, vae, mesh=mesh, resume_enabled=tp > 1,
                                                               **kw, **paged_kw)),
            ):
                t0 = time.perf_counter()
                drive = dict(hit=True, resume=True) if (tp > 1 and layout == "paged") else {}
                label = f"tp={tp} {layout}" + (" (prefix hit, resume)" if drive else "")
                record = tp_run(torch, label, make, specs, reference, margins, tp, **drive)
                err = (record.pop("first_logits") - unsharded_first).abs().max().item()
                record["first_logits_max_abs_err"] = err
                print(f"check {label}: first-position logits vs the unsharded model's max_abs_err {err:.4e} "
                      f"(tol {TP_LOGIT_TOL} at tp > 1)")
                if tp > 1 and not err <= TP_LOGIT_TOL:
                    fail(f"tensor-parallel run {label}: first-position logits off by {err}")
                runs[label] = record
                walls[label] = time.perf_counter() - t0
        del short
        t0 = time.perf_counter()
        served = finish_mesh_servers(torch, one, two, t_start)
        walls["serve --mesh"] = time.perf_counter() - t0
    finally:
        stop_process(one)
        stop_process(two)
    return dict(errs=errs, timed=timed, runs=runs, served=served, walls=walls)


def tp_fields(tp, name):
    """Phase 14's entries of a decode kernel's line: the head split's worst
    per-shard error (bf16 K/V, and `tp_int8_` the int8 arm), the launches
    of the tensor-parallel engine runs (per shard: each is that run's total
    / the shard count; the tile arm's are the prefill and resume waves'),
    and for kernels 1 and 4 the device ms of an H = 8 and an H = 16 step."""
    runs = tp["runs"]
    out = {}
    for key, label in (("", name), ("int8_", name + "_int8")):
        if label in tp["errs"]:
            out[f"tp_{key}head_split_max_abs_err"] = tp["errs"][label]
    counts = {}
    for run, record in runs.items():
        n = record["launches"].get("flash_decode" if name == "flash_decode_tile" else name, 0)
        n = record["tile_launches"] if name == "flash_decode_tile" else n - (
            record["tile_launches"] if name == "flash_decode" else 0)
        if n:
            counts[run] = {"total": n, "per_shard": n // record["tp"]}
    if counts:
        out["tp_launches"] = counts
    if name in tp["timed"]:
        for h in ("h8", "h16"):
            out[f"tp_step_{h}_ms"] = tp["timed"][name][h]["ms"]
            out[f"tp_step_{h}_device_ms"] = tp["timed"][name][h]["device_ms"]
    return out


# --------------------------------------------------------------- phase 15
# multi-process training through the launch twin: two ranks on the one
# card over Gloo (NCCL refuses two ranks on one GPU)
MULTI_SAMPLES = 12  # rainbow:12 at a global batch of 4: 3 steps
MULTI_LAUNCH_TIMEOUT_S = 180  # the launch takes ~55 s
# A sharded run against its one-process run (`multi_readings`). Each limit
# lies near the geometric mean of the sound runs' largest reading on the
# card and the smallest reading there of a planted fault that moves the
# number (`scripts/torch_multi_fault_probe.py`, NVIDIA H100 80GB HBM3,
# 700 W; the readings in PERF.md):
# each step's loss, relative: sound <= 4.2e-6, half the batch 1.6e-4
MULTI_LOSS_RTOL = 2.5e-5
# the first step's averaged gradient before clipping, the worst
# parameter's relative 2-norm: sound <= 4.6e-3, no all-reduce 0.50
MULTI_GRAD_RTOL = 5e-2
# the export's change over the run, the worst parameter's relative
# 2-norm: sound <= 5.2e-3, no all-reduce 0.17
MULTI_UPDATE_RTOL = 3e-2


def multi_trainer_args(run_dir, vae_path, rows, *extra):
    """Phase 15's trainer flags: phase 13's model (the flagship width at
    TRAINER_DEPTH, shift and rotary, the 8k vocabulary, bf16 autocast,
    forward_reverse_partial), one epoch of rainbow:MULTI_SAMPLES, `rows`
    rows a data rank, no step checkpoints."""
    return [
        "--device", "cuda", "--image_text_folder", f"rainbow:{MULTI_SAMPLES}",
        "--vae_path", str(vae_path), "--batch_size", str(rows), "--exp", "r", "--epochs", "1",
        "--set", "model.dim=1024", "--set", f"model.depth={TRAINER_DEPTH}",
        "--set", "model.heads=16", "--set", "model.dim_head=64", "--set", "model.text_seq_len=256",
        "--set", "model.shift_tokens=true", "--set", "model.rotary_emb=true",
        "--set", "native=true", "--set", f"bpe_path={REPO / REST_VOCAB}",
        "--set", "save_every_n_steps=0", "--set", f"output_dir={run_dir}", *extra,
    ]


def multi_counters():
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops.flash_decode import flash_decode_attention

    return fa.flash_attention_fwd, fa.flash_attention_bwd, flash_decode_attention


def flat_tree(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": array} (the npz names)."""
    import numpy as np

    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat_tree(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


class capture_updates:
    """Inside the block the trainer's optimizer, at its first step, puts
    in `store` the averaged gradient of every parameter before clipping
    (`grad`: one float32 vector in parameter order, fsdp pieces gathered
    whole: a collective every rank runs; `grad_sizes`: each parameter's
    name and size in it) and, with `start`, the parameters then under the
    export's names (`start`)."""

    def __init__(self, store, start=False):
        self.store, self.start = store, start

    def __enter__(self):
        import torch

        from dalle_pytorch_tpu_torch import train_dalle
        from dalle_pytorch_tpu_torch.parallel.fsdp import fsdp_of
        from dalle_pytorch_tpu_torch.weights import export_dalle_params

        self.trainer, self.made = train_dalle, train_dalle.make_dalle_train_step
        store, start, made = self.store, self.start, self.made

        def making(model, optimizer, *args, **kwargs):
            step = made(model, optimizer, *args, **kwargs)
            fsdp = fsdp_of(model)
            pieces = {id(e.param): e for e in fsdp.entries} if fsdp is not None else {}
            stepping = optimizer.step

            def first_step(*a, **kw):
                optimizer.step = stepping
                with torch.no_grad():
                    parts, sizes = [], []
                    for name, p in model.named_parameters():
                        g = p.grad if p.grad is not None else torch.zeros_like(p)
                        if id(p) in pieces:
                            g = fsdp.gather(pieces[id(p)], g, torch.float32)
                        parts.append(g.float().reshape(-1).cpu())
                        sizes.append((name, parts[-1].numel()))
                    store["grad"], store["grad_sizes"] = torch.cat(parts).numpy(), sizes
                    if start:
                        store["start"] = flat_tree(export_dalle_params(model), "dalle/")
                return stepping(*a, **kw)

            optimizer.step = first_step
            return step

        train_dalle.make_dalle_train_step = making
        return store

    def __exit__(self, *exc):
        self.trainer.make_dalle_train_step = self.made


def train_rank(argv, plant=None):
    """One rank of phase 15, started by the launch twin as `chip_smoke.py
    --train-rank OUT_DIR -- <trainer flags> [--then <trainer flags> ...]`:
    each run of the trainer in-process in turn in one process group
    (joined here, as the trainer joins it), its kernel launches counted
    from zero around it;
    run i's summary goes to OUT_DIR/run<i>/rank<r>.json, and rank 0 writes
    the run's first averaged gradient (`capture_updates`) to
    OUT_DIR/run<i>/grad.npy. `plant(i)`, a context manager, wraps run i
    (the fault probe's planted faults)."""
    from contextlib import nullcontext

    import numpy as np

    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from dalle_pytorch_tpu_torch import train_dalle
    from dalle_pytorch_tpu_torch.parallel.mesh import initialize_distributed, rank_device

    out, runs = Path(argv[0]), [[]]
    for arg in argv[2:]:
        if arg == "--then":
            runs.append([])
        else:
            runs[-1].append(arg)
    initialize_distributed(device=rank_device(runs[0][runs[0].index("--device") + 1]))
    counters = multi_counters()
    ready_at = time.time()  # the process is up, the port imported
    for i, trainer_argv in enumerate(runs):
        for c in counters:
            c.launches = 0
        store = {}
        t0 = time.perf_counter()
        with capture_updates(store), (plant(i) if plant is not None else nullcontext()):
            summary = train_dalle.main(trainer_argv)
        wall = time.perf_counter() - t0
        run_out = out / f"run{i}"
        run_out.mkdir(parents=True, exist_ok=True)
        if summary["rank"] == 0:
            np.save(run_out / "grad.npy", store["grad"])
        keep = ("rank", "backend", "mesh", "global_step", "step_losses", "step_ms", "export_s",
                "sample_s", "staged_calls", "collective_calls", "collective_bytes", "out_file")
        record = {k: summary[k] for k in keep}
        record.update(wall_s=wall, ready_at=ready_at, end_at=time.time(),
                      launches={c.__name__: c.launches for c in counters},
                      sample_shape=list(np.shape(summary["sample_tokens"])) if "sample_tokens" in summary else None)
        (run_out / f"rank{summary['rank']}.json").write_text(json.dumps(record))
    dist.destroy_process_group()
    return 0


def launch_ranks(out, runs, rank_cmd=None, timeout=MULTI_LAUNCH_TIMEOUT_S):
    """The trainer runs `runs` (flag lists) one after the other on each of
    two ranks of the one card, through one `python -m
    dalle_pytorch_tpu_torch.launch --nproc_per_host 2`; `rank_cmd` is each
    rank's command before its "--" (default `chip_smoke.py --train-rank
    OUT`). Returns each run's rank records."""
    out.mkdir(parents=True, exist_ok=True)
    argv = []
    for i, args in enumerate(runs):
        argv += (["--then"] if i else []) + list(args)
    rank_cmd = rank_cmd or [str(REPO / "chip_smoke.py"), "--train-rank", str(out)]
    started = time.time()
    # its own process group, so that a timeout kills the ranks with it (a
    # rank left alive would hold the pipes open); Gloo over the loopback
    # device, as the rendezvous is on 127.0.0.1
    proc = subprocess.Popen(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.launch", "--nproc_per_host", "2", "--",
         *rank_cmd, "--", *argv],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
        env={**os.environ, "GLOO_SOCKET_IFNAME": "lo"},
    )
    CHILDREN.append(proc)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        kill_group(proc)
        stdout, stderr = proc.communicate()
        fail(f"the launch twin ran past {timeout} s; its ranks were killed: {stderr[-3000:]}")
    finally:
        kill_group(proc)
        CHILDREN.remove(proc)
    for line in stdout.splitlines():
        if line.startswith("rank "):
            print(f"phase 15 {line}")
    if proc.returncode != 0:
        fail(f"the launch twin exited {proc.returncode}: {stderr[-3000:]}")
    done = time.time()
    records = [[json.loads((out / f"run{i}" / f"rank{r}.json").read_text()) for r in range(2)]
               for i in range(len(runs))]
    for r in records[0]:
        r["started_s"] = r["ready_at"] - started
    for r in records[-1]:
        r["exited_s"] = done - r["end_at"]
    print("phase 15 launch: ranks up (the port imported) after "
          + ", ".join(f"{r['started_s']:.1f}" for r in records[0]) + " s, the trainer runs "
          + "; ".join(", ".join(f"{r['wall_s']:.1f}" for r in run) for run in records)
          + " s, the launch over " + ", ".join(f"{r['exited_s']:.1f}" for r in records[-1]) + " s after")
    for i, run in enumerate(records):
        for r in run:
            r["grad_file"] = str(out / f"run{i}" / "grad.npy")
    return records


def export_params(path):
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("dalle/")}, int(z["opt/0002"])


def multi_readings(ref, ranks):
    """A sharded run's readings against its one-process run `ref` (the
    trainer's summary with `capture_updates`' `grad`, `grad_sizes` and
    `start`): each step's loss (relative), the first step's averaged
    gradient and the export's change over the run (the change being the
    export less `start`) as relative 2-norms ||sharded - one|| / ||one||,
    over all parameters and for the worst one, and the export's largest
    difference. Summed in float64 on the card."""
    import numpy as np
    import torch

    dev = "cuda" if torch.cuda.is_available() else "cpu"

    def on(x):
        return torch.from_numpy(np.asarray(x)).to(dev, torch.float64)

    def rel(pairs):
        """(over all, the worst one's name, the worst one) of relative
        2-norms from (||difference||^2, ||reference||^2) by name."""
        num, den = (sum(p[i] for p in pairs.values()) for i in (0, 1))
        each = {k: math.sqrt(d / r) for k, (d, r) in pairs.items() if r > 0}
        worst = max(each, key=each.get)
        return math.sqrt(num / den), worst, each[worst]

    losses = ranks[0]["step_losses"]
    grad, g_ref, edges, g_pairs = on(np.load(ranks[0]["grad_file"])), on(ref["grad"]), 0, {}
    for name, size in ref["grad_sizes"]:
        g, r = grad[edges:edges + size], g_ref[edges:edges + size]
        g_pairs[name] = (float((g - r).square().sum()), float(r.square().sum()))
        edges += size
    params, count = export_params(ranks[0]["out_file"])
    want, want_count = export_params(ref["out_file"])
    same_names = sorted(params) == sorted(want)
    diffs, u_pairs = {}, {}
    for k in want if same_names else []:
        w = on(want[k])
        d = on(params[k]) - w
        diffs[k] = float(d.abs().max())
        u_pairs[k] = (float(d.square().sum()), float((w - on(ref["start"][k])).square().sum()))
    worst = max(diffs, key=diffs.get) if diffs else None
    g_all, g_worst, g_worst_rel = rel(g_pairs)
    u_all, u_worst, u_worst_rel = rel(u_pairs) if u_pairs else (None, None, None)
    return dict(
        losses=losses, ref_losses=ref["step_losses"],
        ranks_agree=all(r["step_losses"] == losses for r in ranks),
        loss_max_rel_diff=max(abs(a - b) / abs(b) for a, b in zip(losses, ref["step_losses"])),
        grad_rel_diff=g_all, grad_worst_rel_diff=g_worst_rel, grad_worst=g_worst,
        update_rel_diff=u_all, update_worst_rel_diff=u_worst_rel, update_worst=u_worst,
        param_max_abs_diff=diffs.get(worst), param_worst=worst, same_names=same_names,
        adam_count=count, ref_adam_count=want_count,
    )


def hold_multi(label, out):
    """Phase 15's limits on a sharded run's `multi_readings`."""
    print(f"phase 15 {label} against one process: " + json.dumps(out))
    steps, losses = MULTI_SAMPLES // 4, out["losses"]
    if not out["ranks_agree"]:
        fail(f"phase 15 {label}: the ranks report different losses")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
            or out["loss_max_rel_diff"] > MULTI_LOSS_RTOL:
        fail(f"phase 15 {label}: losses {losses} against {out['ref_losses']} (rtol {MULTI_LOSS_RTOL})")
    if not out["grad_worst_rel_diff"] <= MULTI_GRAD_RTOL:
        fail(f"phase 15 {label}: the first gradient of {out['grad_worst']} off by "
             f"{out['grad_worst_rel_diff']:.3e} relative (limit {MULTI_GRAD_RTOL})")
    if not out["same_names"] or not out["update_worst_rel_diff"] <= MULTI_UPDATE_RTOL \
            or (out["adam_count"], out["ref_adam_count"]) != (steps, steps):
        fail(f"phase 15 {label}: the export's change of {out['update_worst']} off by "
             f"{out['update_worst_rel_diff']} relative (limit {MULTI_UPDATE_RTOL}), same names "
             f"{out['same_names']}, Adam count {out['adam_count']} against {out['ref_adam_count']}")


class cli_precision:
    """Torch's default precision settings (TF32 off for matmuls, on for
    cuDNN), as the CLI runs, inside the block."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.kept = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = True, False

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self.kept


def multi_setup(torch, run_dir):
    """A fresh `run_dir` holding phase 15's dVAE (the trainer's in-step
    encoder); returns its path."""
    import shutil

    from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
    from dalle_pytorch_tpu_torch.training.pipeline import save_vae_checkpoint

    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    torch.manual_seed(SEED)
    vae_path = run_dir / "vae.npz"
    save_vae_checkpoint(str(vae_path), DiscreteVAE(
        image_size=256, num_layers=3, num_tokens=8192, codebook_dim=512, hidden_dim=64))
    return vae_path


def multi_one_process(torch, args):
    """The trainer in this process on `args`: its summary with its kernel
    launches, `capture_updates`' `grad` and `start`, and its wall."""
    from dalle_pytorch_tpu_torch import train_dalle

    counters = multi_counters()
    for c in counters:
        c.launches = 0
    store = {}
    t0 = time.perf_counter()
    with capture_updates(store, start=True):
        summary = train_dalle.main(args)
    torch.cuda.synchronize()
    summary.update(store, wall_s=time.perf_counter() - t0,
                   launches={c.__name__: c.launches for c in counters})
    return summary


def check_nccl_collectives(torch):
    """A one-rank NCCL group in this process: each call of
    `parallel/collectives.py` once on a CUDA tensor (the ring's hop as a
    send to itself), the values checked, nothing staged."""
    import datetime

    import torch.distributed as dist

    from dalle_pytorch_tpu_torch.parallel.collectives import Collectives

    store_dir = REPO / "build" / "chip_smoke"
    store_dir.mkdir(parents=True, exist_ok=True)
    store = store_dir / "nccl_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            device_id=torch.device("cuda:0"), timeout=datetime.timedelta(seconds=120))
    try:
        comm, world = Collectives("nccl", "cuda:0"), dist.group.WORLD
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        got = {
            "all_reduce": comm.all_reduce(x.clone(), world),
            "all_gather": comm.all_gather(x, world, 0),
            "reduce_scatter": comm.reduce_scatter(x, world, 0),
            "broadcast": comm.broadcast(x.clone(), world, [0]),
            "ring_shift": comm.ring_shift(x, world, [0], 0),
        }
        torch.cuda.synchronize()
        bad = [k for k, v in got.items() if not (v.is_cuda and torch.equal(v, x))]
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    print(f"phase 15 NCCL, one rank on cuda:0: calls {dict(comm.calls)}, staged {dict(comm.staged)}")
    if bad or comm.staged or set(comm.calls) != set(got):
        fail(f"phase 15 NCCL collectives: wrong values {bad}, staged {dict(comm.staged)}")
    return dict(comm.calls)


def run_multi_process_training(torch, smi):
    """Phase 15: DALLE training over two processes on the one card,
    through `python -m dalle_pytorch_tpu_torch.launch --nproc_per_host 2
    -- ... train_dalle`, at the flagship width (depth TRAINER_DEPTH, bf16
    autocast, a global batch of 4, MULTI_SAMPLES // 4 steps): (a) one
    process (in-process, the reference); (b) fsdp = 2, two rows a rank,
    one in-loop sample at step 3 on both ranks over the gathered
    parameters; (c) sp = 2 with `attn_impl="ring"`, all four rows on both
    ranks, held to (c1) the same ring run in one process; (b) and (c) run
    in turn in one launch. Each sharded run's per-step losses, first
    averaged gradient and export held to its one-process run
    (`hold_multi`), the flash-attention kernels (rows 6-8) launched on
    each fsdp rank (2 x depth a step each way), the ring's hops staged
    through host memory under Gloo and counted, the other collectives not
    staged; then the NCCL check. Under torch's default precision
    settings, as the CLI runs. Returns the summary."""
    import shutil

    run_dir = REPO / "build" / "chip_smoke" / "multi"
    steps = MULTI_SAMPLES // 4
    walls, result = {}, {"card": smi}

    def args(label, rows, *extra):
        return multi_trainer_args(run_dir / label, vae_path, rows, *extra)

    try:
        with cli_precision(torch):
            vae_path = multi_setup(torch, run_dir)
            world1 = multi_one_process(torch, args("a_world1", 4, "--set", "log_images_freq=0"))
            ring1 = multi_one_process(torch, args("c1_ring_world1", 4, "--set", "model.attn_impl=ring",
                                                  "--set", "log_images_freq=0"))
            t0 = time.perf_counter()
            fsdp, ring = launch_ranks(run_dir / "ranks", [
                args("b_fsdp2", 2, "--set", "mesh.fsdp=2", "--set", f"log_images_freq={steps}"),
                args("c_ring_sp2", 4, "--set", "model.attn_impl=ring", "--set", "mesh.sp=2",
                     "--set", "log_images_freq=0"),
            ])
            walls.update(a_world1=world1["wall_s"], c1_ring_world1=ring1["wall_s"],
                         bc_launch=time.perf_counter() - t0)
            t0 = time.perf_counter()
            result["fsdp2"] = multi_readings(world1, fsdp)
            result["ring_sp2"] = multi_readings(ring1, ring)
            walls["readings"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["nccl_calls"] = check_nccl_collectives(torch)
        walls["d_nccl"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    attn = 2 * TRAINER_DEPTH * steps
    want = {"flash_attention_fwd": attn, "flash_attention_bwd": attn}
    launches = {"world1": world1["launches"], **{f"fsdp2_rank{r['rank']}": r["launches"] for r in fsdp},
                "ring_world1": ring1["launches"], **{f"ring_sp2_rank{r['rank']}": r["launches"] for r in ring}}
    result.update(
        launches=launches, walls=walls,
        backends={"fsdp2": [r["backend"] for r in fsdp], "ring_sp2": [r["backend"] for r in ring]},
        staged={"fsdp2": [r["staged_calls"] for r in fsdp], "ring_sp2": [r["staged_calls"] for r in ring]},
        collective_calls={"fsdp2": fsdp[0]["collective_calls"], "ring_sp2": ring[0]["collective_calls"]},
        collective_mib={k: {c: b / 2**20 for c, b in runs[0]["collective_bytes"].items()}
                        for k, runs in (("fsdp2", fsdp), ("ring_sp2", ring))},
        sample_s={"fsdp2": [r["sample_s"] for r in fsdp]},
        rank_walls={"fsdp2": [r["wall_s"] for r in fsdp], "ring_sp2": [r["wall_s"] for r in ring]},
        rank_started_s=[r["started_s"] for r in fsdp], rank_exited_s=[r["exited_s"] for r in ring],
        step_ms={"world1": world1["step_ms"], "fsdp2": [r["step_ms"] for r in fsdp],
                 "ring_world1": ring1["step_ms"], "ring_sp2": [r["step_ms"] for r in ring]},
        export_s={"world1": world1["export_s"], "fsdp2": fsdp[0]["export_s"]},
        tolerances={"loss_rtol": MULTI_LOSS_RTOL, "grad_rtol": MULTI_GRAD_RTOL,
                    "update_rtol": MULTI_UPDATE_RTOL},
    )
    print("multi-process training " + json.dumps(result))
    hold_multi("(b) fsdp = 2", result["fsdp2"])
    hold_multi("(c) ring, sp = 2", result["ring_sp2"])
    hops = 2 * TRAINER_DEPTH * steps * (2 * 2 - 1)  # two objectives: 1 hop forward, 2 backward
    for r in fsdp:
        got = {k: r["launches"][k] for k in want}
        if got != want:
            fail(f"phase 15 fsdp rank {r['rank']} launched {got}, expected {want}")
        if r["launches"]["flash_decode_attention"] != TRAINER_DEPTH * (1 + 1024) or r["sample_shape"] != [1, 1024]:
            fail(f"phase 15 fsdp rank {r['rank']}: the in-loop sample launched flash decode "
                 f"{r['launches']['flash_decode_attention']} times, tokens {r['sample_shape']}")
        if r["backend"] != "gloo" or r["staged_calls"]:
            fail(f"phase 15 fsdp rank {r['rank']}: backend {r['backend']}, staged {r['staged_calls']}")
    if {k: world1["launches"][k] for k in want} != want:
        fail(f"phase 15 one-process run launched {world1['launches']}, expected {want}")
    for r in ring:
        if r["backend"] != "gloo" or r["staged_calls"] != {"ring_shift": hops}:
            fail(f"phase 15 ring rank {r['rank']}: backend {r['backend']}, staged {r['staged_calls']}, "
                 f"expected {hops} ring hops")
    return result


def build_mesh(devices):
    """A tp mesh over explicit devices (one card may be named twice)."""
    from dalle_pytorch_tpu_torch.serving.sharded import build_serving_mesh

    return build_serving_mesh({"tp": len(devices)}, devices=devices)


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

    sys.stdout.reconfigure(line_buffering=True)
    start_watchdog()
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
    progress("phase 1")
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
    progress("phase 2")
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
    progress("phase 3")
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
    progress("phase 4")
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
    progress("phase 5")
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
    progress("phase 6")
    vae, model5 = engine.vae, engine.model
    micro_engine, tokens5, wall5 = engine, toks, wall  # served again, warm, in phase 11
    del engine
    train_launches, _ = run_training(torch, vae, specs)
    launches.update(train_launches)
    t0 = time.perf_counter()
    fp32_train = run_fp32_training(torch)
    print(f"phase 6b fp32 training: {time.perf_counter() - t0:.1f} s")

    # 7. continuous-serving path ---------------------------------------------------
    progress("phase 7")
    t0 = time.perf_counter()
    continuous_launches, patterned, patterned_toks, (short_toks, int8_toks) = (
        run_continuous(torch, model5, vae, specs))
    launches.update(continuous_launches)
    print(f"phase 7 continuous serving: {time.perf_counter() - t0:.1f} s")

    # 8. paged continuous serving with a prefix cache ---------------------------------
    progress("phase 8")
    t0 = time.perf_counter()
    launches.update(run_paged(torch, model5, patterned, vae, specs, patterned_toks, short_toks))
    print(f"phase 8 paged serving: {time.perf_counter() - t0:.1f} s")

    # 9. the generation CLI end to end ----------------------------------------------
    progress("phase 9")
    t0 = time.perf_counter()
    cli_launches, _ = run_generation_cli(torch, vae)
    print(f"phase 9 generation CLI: {time.perf_counter() - t0:.1f} s")

    # 10. mid-decode resume and migration -------------------------------------------
    progress("phase 10")
    t0 = time.perf_counter()
    migrated = run_migration(torch, model5, vae, specs, short_toks, int8_toks)
    print(f"phase 10 resume and migration: {time.perf_counter() - t0:.1f} s")

    # 11. the serving front end over HTTP ---------------------------------------------
    progress("phase 11")
    t0 = time.perf_counter()
    served_micro = run_micro_server(torch, micro_engine, tokens5, wall5)
    t_micro = time.perf_counter() - t0
    del micro_engine
    served = run_continuous_server(torch, model5, vae, specs, short_toks)
    print(f"phase 11 serving over HTTP ({smi}): {time.perf_counter() - t0:.1f} s (micro server "
          f"{t_micro:.1f} s; continuous server warmup {served['warmup_s']:.1f} s, "
          + ", ".join(f"{k} {v:.1f}" for k, v in served["walls"].items()) + ")")
    # 12. the trainer end to end --------------------------------------------------------
    progress("phase 12")
    t0 = time.perf_counter()
    trainer = run_trainer(torch, smi)
    print(f"phase 12 the trainer ({smi}): {time.perf_counter() - t0:.1f} s (run A "
          f"{trainer['run_wall_s']['A']:.1f} s, run B {trainer['run_wall_s']['B']:.1f} s)")
    # 14. tensor-parallel serving, run before phase 13: phase 13 ends with a
    # torch.profiler trace, and every launch after a trace goes through the
    # tracer, which phase 14's millions of launches leave dropping records
    # (and with its serve processes, whole traces) in the traces at the end
    progress("phase 14")
    t0 = time.perf_counter()
    tp = run_tensor_parallel(torch, model5, vae, specs, short_toks, smi)
    print(f"phase 14 tensor-parallel serving ({smi}): {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in tp["walls"].items()) + ")")
    # 15. multi-process training, run before phase 13's trace too: its
    # one-process reference runs launch in this process
    progress("phase 15")
    t0 = time.perf_counter()
    multi = run_multi_process_training(torch, smi)
    print(f"phase 15 multi-process training ({smi}): {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in multi["walls"].items()) + ")")
    # 13. the rest of training ----------------------------------------------------------
    progress("phase 13")
    t0 = time.perf_counter()
    rest = run_rest_of_training(torch, smi)
    print(f"phase 13 the rest of training ({smi}): {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in rest["walls"].items()) + ")")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s after the build started")

    # device time per call of phase 3's kernel rows, and the kernel the
    # forward's row ran, from traces made after every timed phase: a
    # torch.profiler trace leaves the CUDA tracer attached, which slows
    # each launch after it
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    progress("the device-time traces")
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
    for name, rows in tp["timed"].items():
        print(f"phase 14 {name} step bf16 at H = 8 (one shard of tp = {TP}) device ms "
              f"{rows['h8']['device_ms']:.5f} (events {rows['h8']['ms']:.5f}), at H = 16 "
              f"{rows['h16']['device_ms']:.5f} (events {rows['h16']['ms']:.5f}) ({smi})")
    for (d, key, _), row in wide_times["wide_step"].items():
        seen = row.get("device_kernels", {})
        if not any(k.startswith("wide_split_kernel") for k in seen):
            fail(f"the {key} step at D = {d}: the trace shows {list(seen)}, not wide_split_kernel")
        row["cuda_kernel"] = " + ".join(seen)
        row["library_cuda_kernel"] = " + ".join(row.get("library_device_kernels", {}))
        print(f"phase 3 step at D = {d} {key}: {row['cuda_kernel']} device {row['device_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f}, SDPA {row['library_device_ms']:.4f} ({row['library_cuda_kernel']})")

    print(trace_attempts_line())
    progress("the result lines")

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
                **tp_fields(tp, "flash_decode"),
                served_launches={"micro_server": served_micro["launches"]["flash_decode"],
                                 "continuous_server_qos": served["qos"]["launches"]["flash_decode"]},
                trainer_sample_launches=trainer["launches"]["A"]["flash_decode_attention"],
                multi_process_sample_launches={run: n["flash_decode_attention"]
                                               for run, n in multi["launches"].items() if "fsdp" in run},
                rest_launches=(rest["revnet_serving"]["launches"]["flash_decode"]
                               - rest["revnet_serving"]["launches"]["flash_decode_tile"]),
                bound_ms=step["bound_ms"],
                bound_by=step["bound_by"],
                library_ms=step["library_ms"],
                library_device_ms=step["library_device_ms"],
                **{f"fp32_{k}": v for k, v in timings[("step", "fp32")].items() if "kernels" not in k},
                timed="bf16 step n=1 B=4 H=16 D=64 S=1281 lengths [258, 700, 1024, 1281] (fp32_*: "
                "the same step with fp32 q and cache, bound at the fp32 peak); "
                "launches: phase 5's steps (its prefill is the tile arm's); cli_launches: phase "
                "9's generation CLI (2 prompts x one batch of 4, prefill included); served_launches: "
                "phase 11's HTTP runs, all arms (the micro server's batch of 4 at depth 12; the "
                f"continuous server's QoS run at depth {SHORT_DEPTH}, its prefill and resume waves included); "
                "trainer_sample_launches: phase 12's in-loop sample (fp32, all arms, prefill included); "
                "multi_process_sample_launches: phase 15's in-loop sample on each fsdp rank (the same); "
                "rest_launches: phase 13's RevNet engine (its steps, through the two-stream cached branch)",
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
                rest_launches=rest["revnet_serving"]["launches"]["flash_decode_tile"],
                **tp_fields(tp, "flash_decode_tile"),
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
                "function); launches: phase 5's prefill (one a layer; rest_launches: phase 13's RevNet "
                "engine's prefill); resume_*: n=1280 S=1281 B=4 "
                "lengths 1280, launches per resume dispatch of phase 10 (slotted, paged; int8_: "
                f"the int8 run; all three at depth {SHORT_DEPTH}); max_abs_err: worst of prefill, prefill_edges, resume B=1 "
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
                trainer_launches={run: n[name] for run, n in trainer["launches"].items()},
                multi_process_launches={run: n[name] for run, n in multi["launches"].items()},
                rest_launches={**{run: r["launches"][name] for run, r in rest["revnet_runs"].items()},
                               "scan": rest["scan"]["launches"][name]},
                rest_trace=rest["revnet_gradients"]["bf16_trace"],
                timed="bf16 causal B=4 H=16 N=1280 D=64"
                + ("" if name.endswith("fwd") else "; one fused kernel for dq, dk and dv; "
                   "library_ms is SDPA's whole backward, whole_backward_ms the port's (delta "
                   "+ workspace zeroing + kernel + dq conversion)")
                + "; fp32_*: the same shapes in fp32 (the 3xTF32 tensor-core kernels), bound at three "
                "times the flops at the TF32 peak; trainer_launches: phase 12's trainer runs A and B "
                f"(8 steps each at depth {TRAINER_DEPTH}, two objectives a step); rest_launches: phase "
                f"13's trainer runs ({REST_SAMPLES // 4} steps of the RevNet and of revnet_naive, "
                f"{REST_SCAN_SAMPLES // 4} of the scan run, depth {REST_DEPTH}, two objectives a step; "
                "the RevNet's forward calls include its backward's recompute); rest_trace: the "
                "attention kernels of one bf16 RevNet step (a torch.profiler trace); "
                f"multi_process_launches: phase 15's runs ({MULTI_SAMPLES // 4} steps at depth "
                f"{TRAINER_DEPTH}, two objectives a step: one process, each of the two fsdp ranks, "
                "and the ring runs, whose attention is the plain ring)",
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
                **tp_fields(tp, "flash_decode_int8"),
                **variant_times["flash_decode_int8"],
                timed="bf16 q, int8 K/V + fp32 scales, step n=1 B=4 H=16 D=64 S=1281 lengths "
                f"[258, 700, 1024, 1281]; launches: phase 7 int8 run's steps (depth {SHORT_DEPTH}; its "
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
                **tp_fields(tp, "block_sparse_flash_decode"),
                **variant_times["block_sparse_flash_decode"],
                **{f"tile_resume_{k}": v for k, v in tile_variant_times["block_sparse_flash_decode"].items()
                   if k != "device_kernels"},
                timed="bf16 step n=1 B=4 H=16 D=64 S=1281, axial_row policy bitmap; launches: "
                f"phase 7 policy run's steps (bf16 arm, depth {SHORT_DEPTH}) + policy+int8 patterned run's "
                f"(int8 arm, depth {PATTERNED_DEPTH}; both runs' prefills are the tile arm's); "
                "library_ms is SDPA with the bitmap-expanded mask",
            ),
            dict(
                name="paged_flash_decode",
                route="cuda",
                source="dalle_pytorch_tpu_torch/csrc/flash_decode.cu",
                replaces="dalle_pytorch_tpu/ops/pallas_decode.py:446",
                launches=launches["paged_flash_decode"],
                max_abs_err=paged_errs["paged_flash_decode"],
                **tp_fields(tp, "paged_flash_decode"),
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
                **tp_fields(tp, "block_sparse_paged_flash_decode"),
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
    if sys.argv[1:2] == ["--train-rank"]:
        sys.exit(train_rank(sys.argv[2:]))
    sys.exit(main())
