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
   small shapes for the other head dims the wrappers accept; for flash
   attention also a ragged length and an axial_row static mask, each
   output held per element and per 64-row tile, and in bfloat16 also
   against the plain version that rounds P and dS as the kernels do);
3. times with CUDA events: each kernel, its plain version and one PyTorch
   library call computing the same function, beside the kernel's bound
   (the larger of bytes over memory bandwidth and flops over peak rate
   for the input type, this card's published peaks);
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
   `generate()` from it (train -> checkpoint -> serve).

The line before the last is the card's nvidia-smi line, the one before
that a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout, it exits nonzero before any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
LAYERS = 12  # flagship depth: the timed inputs rotate over this many copies
MAIN = dict(batch=4, heads=16, dim_head=64, cache=1281, prefill=257)
TRAIN = dict(batch=4, heads=16, n=1280, dim_head=64)  # flash attention's shapes
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


def attention_bound(kind, elt, peaks, dtype_key):
    """(bound_ms, bound_by) of one flash-attention pass at TRAIN's causal
    shapes: each input read once and each output written once; 4*D (fwd),
    6*D (dq) or 8*D (dk/dv) flops per visible (query, key) pair."""
    b, h, n, d = TRAIN["batch"], TRAIN["heads"], TRAIN["n"], TRAIN["dim_head"]
    rows, pairs = b * h * n, b * h * n * (n + 1) // 2
    nbytes, flops = {
        "fwd": (4 * rows * d * elt + 4 * rows, 4 * d * pairs),   # q,k,v,o + lse
        "dq": (5 * rows * d * elt + 8 * rows, 6 * d * pairs),    # q,k,v,do,dq + lse,delta
        "dkv": (6 * rows * d * elt + 8 * rows, 8 * d * pairs),   # q,k,v,do,dk,dv + lse,delta
    }[kind]
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / peaks[dtype_key]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, inputs, iters):
    """Mean ms per call over `iters` calls rotating through `inputs` (one
    set per layer: each call finds its K/V cold in L2, as in decode)."""
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


def attention_case(torch, label, b, h, n_q, n_k, d, dtype, mask=None, seed=SEED):
    """Each flash-attention kernel against its plain version on the same
    inputs (the kernels run first, so no buffer can hold a plain result),
    under ATTN_TOL; bf16 against both the exact and the rounding-matched
    plain version. The backward passes take the kernel forward's lse and
    delta. Returns {kernel: max_abs_err against the exact version}."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(b, h, n_q, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, h, n_k, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    fm = None if mask is None else fa.flash_mask(mask, "cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, fm)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, fm)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, fm)
    torch.cuda.synchronize()
    outs = {"fwd": (o, lse), "dq": (dq,), "dkv": (dk, dv)}

    def plain(p_dtype):
        return {
            "fwd": fa.flash_attention_forward_plain(q, k, v, fm, p_dtype=p_dtype),
            "dq": (fa.flash_attention_dq_plain(q, k, v, do, lse, delta, fm, p_dtype=p_dtype),),
            "dkv": fa.flash_attention_dkv_plain(q, k, v, do, lse, delta, fm, p_dtype=p_dtype),
        }

    refs = {"exact": plain(None)}
    if dtype == torch.bfloat16:
        refs["matched"] = plain(torch.bfloat16)
    errs, report, failures = {}, [], []
    for kind, outputs in outs.items():
        name = f"flash_attention_{kind}"
        for ref_kind, ref in refs.items():
            for i, (out, r) in enumerate(zip(outputs, ref[kind])):
                tensor = ("o", "lse", "dq", "dk", "dv")[{"fwd": 0, "dq": 2, "dkv": 3}[kind] + i]
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
        + " max_abs_err; element, tile ratios: " + "; ".join(report)
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
        ] + [(f"small", 2, 2, 100, 100, dd, None) for dd in (16, 32, 128)]
        for label, *shape, mask in cases:
            errs = attention_case(torch, label, *shape, dtype, mask=mask)
            if dtype == torch.bfloat16:
                for kernel, err in errs.items():
                    worst[kernel] = max(worst.get(kernel, 0.0), err)
    return worst


def time_attention(torch, F, peaks, dtype, key, elt):
    """Kernel, plain and library times of the three passes at TRAIN's
    causal shapes (inputs rotate over 3 copies). SDPA's backward computes
    dq, dk and dv in one call: its time is library_ms of both backward
    rows, beside the sum of theirs."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    b, h, n, d = TRAIN["batch"], TRAIN["heads"], TRAIN["n"], TRAIN["dim_head"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sets = []
    for _ in range(3):
        q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
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

    rows = {
        "flash_attention_fwd": dict(
            ms=time_ms(torch, fa.flash_attention_fwd, fwd_in, 30),
            plain_ms=time_ms(torch, fa.flash_attention_forward_plain, fwd_in, 6),
            library_ms=time_ms(torch, lib_fwd, fwd_in, 30),
        ),
        "flash_attention_dq": dict(
            ms=time_ms(torch, fa.flash_attention_dq, sets, 30),
            plain_ms=time_ms(torch, fa.flash_attention_dq_plain, sets, 6),
        ),
        "flash_attention_dkv": dict(
            ms=time_ms(torch, fa.flash_attention_dkv, sets, 30),
            plain_ms=time_ms(torch, fa.flash_attention_dkv_plain, sets, 6),
        ),
    }
    lib_bwd_ms = time_ms(torch, lib_bwd, lib_bwd_in, 30)
    for kind in ("dq", "dkv"):
        rows[f"flash_attention_{kind}"]["library_ms"] = lib_bwd_ms
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = attention_bound(name[16:], elt, peaks, key)
        print("time " + json.dumps(dict(kernel=name, dtype=key, B=b, H=h, N=n, D=d, causal=True, **row)))
    print(
        f"time flash_attention backward {key}: dq + dk/dv "
        f"{rows['flash_attention_dq']['ms'] + rows['flash_attention_dkv']['ms']:.3f} ms, "
        f"SDPA backward {lib_bwd_ms:.3f} ms"
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
    counters = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv)
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
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {line.strip()}")

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
    # the other head dims the wrapper accepts, at a small ragged shape
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for d in (16, 32, 128):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (
                torch.randn(shape, generator=g, device="cuda").to(dtype)
                for shape in ((4, 2, 5, d), (4, 2, 100, d), (4, 2, 100, d))
            )
            lens = torch.tensor([5, 37, 64, 100], dtype=torch.int32, device="cuda")
            ref = flash_decode_attention_plain(q, k, v, lens).float()
            err = (flash_decode_attention(q, k, v, lens).float() - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            tol = 2.0**-7 * scale if dtype == torch.bfloat16 else 2e-5 * scale
            print(
                f"check flash_decode D={d} {str(dtype)[6:]} n=5 S=100: "
                f"max_abs_err {err:.3e} tol {tol:.3e}"
            )
            if not err <= tol:
                fail(f"flash_decode D={d} {dtype} disagrees with its plain version")

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
            print("time " + json.dumps(dict(
                kernel="flash_decode", case=case, dtype=key, n=n, lengths=lengths,
                library_max_abs_err=lib_err, **row,
            )))
            del inputs
    step = timings[("step", "bf16")]
    est = LAYERS * (timings[("prefill", "bf16")]["ms"] + 1024 * step["ms"])
    print(f"flash_decode per main-path batch (bf16, from the timed shapes): ~{est:.1f} ms")
    attn_times = time_attention(torch, F, peaks, torch.bfloat16, "bf16", 2)
    time_attention(torch, F, peaks, torch.float32, "fp32", 4)

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
    vae = engine.vae
    del engine
    train_launches, _ = run_training(torch, vae, specs)
    launches.update(train_launches)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s after the build started")

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
                + ("" if name.endswith("fwd") else "; library_ms is SDPA's whole backward"),
            )
            for name, line in (
                ("flash_attention_fwd", 129),
                ("flash_attention_dq", 274),
                ("flash_attention_dkv", 333),
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
