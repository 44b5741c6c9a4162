#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dalle_pytorch_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each failing loudly (nonzero exit, no result line):

1. the card's name and power limit (nvidia-smi), and the build of every
   kernel of the port's main path from `dalle_pytorch_tpu_torch/csrc/`;
2. each kernel against its plain PyTorch version at the main path's
   shapes, in bfloat16 and float32, with the tolerance stated (and at a
   small shape for the other head dims the wrapper accepts);
3. times with CUDA events: the kernel, its plain version and one PyTorch
   library call computing the same function, beside the kernel's bound
   (the larger of bytes over memory bandwidth and flops over peak rate
   for the input type, this card's published peaks);
4. a small float32 model on the card, its cached decode through the
   kernel against the same model through dense attention;
5. the main path once: the micro `GenerationEngine` at the flagship
   width (DALLE dim 1024, depth 12, 16 heads of 64, 256 text + 1024 image
   tokens, 256 px dVAE; random weights from a seed; bfloat16; batch 4),
   `warmup()` then `generate()` of four prompts, with every kernel's
   launch count read from zero around the `generate()` call.

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
        model = DALLE(
            dim=1024, depth=LAYERS, heads=16, dim_head=64, num_image_tokens=8192,
            image_fmap_size=32, num_text_tokens=10000, text_seq_len=256,
            shift_tokens=True, rotary_emb=True, attn_types=("full",),
        )
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
    t0 = time.perf_counter()
    kernels.build(["flash_decode"])
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

    # 5. main path -------------------------------------------------------------
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
