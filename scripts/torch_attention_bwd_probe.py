#!/usr/bin/env python3
"""The flash-attention kernels alone on one GPU: build, hold against the
plain versions, time.

Builds `csrc/flash_attention.cu` (printing nvcc's register, shared-memory
and spill report for every kernel), runs `chip_smoke.py`'s phase-2
checks of flash attention (every case: bf16 and fp32, causal, ragged,
axial_row, n_k > n_q, D = 16/32/48/128/192/256) and its phase-3 timing at
the training shapes (causal, B=4, H=16, N=1280, head dim --d, type
--dtype): kernel, plain version, SDPA, bound, and the whole backward as
the autograd Function runs it, then the device time of the kernel and of
SDPA from torch.profiler traces (the timing first, so a failing check
still leaves the times printed).

    python3 scripts/torch_attention_bwd_probe.py [--dtype bf16|fp32] [--d 64 [256]]
        [--pass fwd|bwd] [--parent DIR] [--ablate [--only NAME,...]] [--rows]

With --parent DIR (an unpacked checkout of another commit, e.g. the
parent's `git archive` under the git-ignored `build/`), the timing runs in
turns in separate processes, parent, this tree, this tree, parent, each
building its own tree's kernels and timing them with this tree's
`chip_smoke.time_attention` (device ms of the kernel and of SDPA), so the
two versions are compared on one card in one call. With --ablate, copies
of `csrc/flash_attention.cu` that each drop or change one part of the pass
named by --pass in the type --dtype (default bwd; `ABLATIONS`: the results
are wrong, only their times count) are built into `build/ablate/` and that
pass's wrapper is timed through each at head dim --d, in two rounds of
opposite order: what each part costs. The bf16 forward's variants: no
mask on any tile, the mask on every tile, 3 blocks an SM (at most 170
registers) instead of 4, no next-tile prefetch (each tile waits for its
own loads), no K/V loads after the first tile, no P.V product, no exp,
and P by expf in base e (the design before base 2). The fp32 backward's
(`--dtype fp32`): no copies, no S, no dP, no second products, one TF32
product of three, no exp, no split pass, and two design variants whose
results are right (one dk/dv block a key tile at D = 256; each build's
registers and spills are printed). The fp32 forward's (`--pass fwd
--dtype fp32`): no copies, no S product, no P V product, one TF32 product
of three, no exp, no split pass, no trade of the S halves; --only picks
some. With --rows it times only the fp32 flash attention at D = 64 and
256 (kernel and SDPA), the fp32 decode step at D = 64 beside SDPA and the
step at D = 1032 (the split-K kernel's wide instance), bf16 and fp32,
beside SDPA, and exits.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# per pass: (variant, text in csrc/flash_attention.cu, its replacement), or
# (variant, ((text, replacement), ...), None) for several edits; every
# occurrence of a text is replaced
ABLATIONS = {
    "bwd": (
        ("full", "", ""),
        ("no_dq_phase", "for (int dc = 0; dc < D / DC; ++dc) {",
         "for (int dc = 0; dc < (mode == 7 ? D / DC : 0); ++dc) {"),
        ("no_dq_atomics", "if (r < nq) red_add4(row + nb * 8, x);",
         "if (r < nq && x.x == 12345.f) red_add4(row + nb * 8, x);"),
        ("no_dk_dv", "for (int kc = 0; kc < 2; ++kc) {\n#pragma unroll\n        for (int nd = 0;",
         "for (int kc = 0; kc < (mode == 7 ? 2 : 0); ++kc) {\n#pragma unroll\n        for (int nd = 0;"),
        ("no_exp", "p[j] = expf(__fsub_rn(__fmul_rn(s[nb][2 * hh + j], scale), lq[j]));",
         "p[j] = __fsub_rn(__fmul_rn(s[nb][2 * hh + j], scale), lq[j]);"),
        ("exp2_folded", "p[j] = expf(__fsub_rn(__fmul_rn(s[nb][2 * hh + j], scale), lq[j]));",
         "p[j] = exp2f(fmaf(s[nb][2 * hh + j], scale * 1.4426950408889634f, "
         "-lq[j] * 1.4426950408889634f));"),
    ),
    "fwd": (
        ("full", "", ""),
        ("no_mask", "if (tile_full(mode, q0, k0, nq, nk))\n      softmax_tile<false>",
         "if (true)\n      softmax_tile<false>"),
        ("mask_every_tile", "if (tile_full(mode, q0, k0, nq, nk))\n      softmax_tile<false>",
         "if (false)\n      softmax_tile<false>"),
        ("three_blocks", "__launch_bounds__(kMmaThreads, D == 128 ? 2 : 4)",
         "__launch_bounds__(kMmaThreads, D == 128 ? 2 : 3)"),
        ("no_prefetch", "if (leader && kn < kend) fetch_kv(st ^ 1, kn);",
         "if (leader && kn < kend) fetch_kv(st ^ 1, kn);\n"
         "    if (kn < kend) mbar_wait(bar0 + 8 * (st ^ 1), ((it + 1) >> 1) & 1);"),
        ("no_loads", "if (leader && kn < kend) fetch_kv(st ^ 1, kn);",
         "if (leader && kn < kend) mbar_expect(bar0 + 8 * (st ^ 1), 0);"),
        ("no_pv", "for (int kk = 0; kk < 4; ++kk) wgmma_rs(",
         "if (mode == 7)\n      for (int kk = 0; kk < 4; ++kk) wgmma_rs("),
        ("no_exp", "s[nb][e] = ex2(__fsub_rn(s[nb][e], m[e / 2]));",
         "s[nb][e] = __fsub_rn(s[nb][e], m[e / 2]);"),
        ("expf", (
            ("float x = __fmul_rn(s[nb][e], scale_log2);", "float x = __fmul_rn(s[nb][e], scale_log2 * kLn2);"),
            ("corr[hh] = ex2(m[hh] - m_new);", "corr[hh] = expf(m[hh] - m_new);"),
            ("s[nb][e] = ex2(__fsub_rn(s[nb][e], m[e / 2]));", "s[nb][e] = expf(__fsub_rn(s[nb][e], m[e / 2]));"),
            ("lse[row] = m[hh] * kLn2 + logf(safe_l);", "lse[row] = m[hh] + logf(safe_l);"),
        ), None),
    ),
    # the fp32 forward (fwd_tf32_kernel)
    "fwd_fp32": (
        ("full", "", ""),
        ("no_copies", (
            ("      fetch(f, ring + st * SLOT);\n", ""),
            ("      fetch(f, ring + ((it + STAGES - 1) % STAGES) * SLOT);\n", ""),
        ), None),
        ("no_s", (
            ("score_product<CH / 2, LDR, LDC, ", "if (mode == 7) score_product<CH / 2, LDR, LDC, "),
            ("        score_product_by<CH / 2, LDC, LO, true, GN>(", "        if (mode == 7) score_product_by<CH / 2, LDC, LO, true, GN>("),
        ), None),
        ("no_pv", (
            ("      frag_product<NT, LDC, LO, GN>(acc, 0, s, buf + P::CHUNK + half, lane);",
             "      if (mode == 7) frag_product<NT, LDC, LO, GN>(acc, 0, s, buf + P::CHUNK + half, lane);"),
            ("        if (cc == c) frag_product_by<", "        if (mode == 7 && cc == c) frag_product_by<"),
            ("        if (cc == c + 1) frag_product_by<", "        if (mode == 7 && cc == c + 1) frag_product_by<"),
        ), None),
        ("one_tf32_product", "  mma_tf32(small, al, bh0, bh1);\n  mma_tf32(small, ah, bl0, bl1);\n", ""),
        ("no_exp", "s[nb][e] = ex2(__fmaf_rn(s[nb][e], scale_log2, -m[e / 2]));",
         "s[nb][e] = (__fmaf_rn(s[nb][e], scale_log2, -m[e / 2]));"),
        ("no_split_pass", "    split_slot<P::CHUNK>(buf, slot);\n", ""),
        ("no_trade", "      put_frag(xchg + role * P::XCHG, grp, lane, s);\n      pair_sync(grp);\n", ""),
    ),
    # the fp32 backward's two TF32 passes (dq_tf32_kernel, dkv_tf32_kernel)
    "bwd_fp32": (
        ("full", "", ""),
        ("no_copies", (  # the ring issues no copies: every item computes on stale slots
            ("      fetch(f, ring + st * SLOT);\n", ""),
            ("      fetch(f, ring + ((it + STAGES - 1) % STAGES) * SLOT);\n", ""),
        ), None),
        ("no_s", "score_product<CH, LDR, LDC, ", "if (role == 1) score_product<CH, LDR, LDC, "),
        ("no_dp", "score_product<CH, LDR, LDC, ", "if (role == 0) score_product<CH, LDR, LDC, "),
        ("no_second_products", "        mma_3xtf32(t[i], u[i], ah, al, bh0, bh1, bl0, bl1);\n", ""),
        ("one_tf32_product", "  mma_tf32(small, al, bh0, bh1);\n  mma_tf32(small, ah, bl0, bl1);\n", ""),
        ("no_exp", "float p = ex2(__fmaf_rn(", "float p = (__fmaf_rn("),
        ("no_split_pass", "    split_slot<P::CHUNK>(buf, slot);\n", ""),
        # design variants (their results are right): one dk/dv block a key
        # tile at D = 256, with fresh partials of 2 or 1 column tiles
        ("kv_split_1", "static constexpr int KV_SPLIT = D > 128 ? 2 : 1;", "static constexpr int KV_SPLIT = 1;"),
        ("kv_split_1_gn1", (
            ("static constexpr int KV_SPLIT = D > 128 ? 2 : 1;", "static constexpr int KV_SPLIT = 1;"),
            ("constexpr int GN = NCO * NT >= 16 ? 2 : 4;", "constexpr int GN = NCO * NT >= 32 ? 1 : NCO * NT >= 16 ? 2 : 4;"),
        ), None),
    ),
}

# one turn: this tree's kernels (the cwd) timed by the probe's chip_smoke,
# at each head dim of {dims}
TIME_ONLY = """
import importlib.util, json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("probe_chip_smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from dalle_pytorch_tpu_torch import kernels
kernels.build(["flash_attention"])
_, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
dtype = {{"bf16": torch.bfloat16, "fp32": torch.float32}}[{key!r}]
for d in {dims!r}:
    rows = cs.time_attention(torch, F, peaks, dtype, {key!r}, {elt}, d=d)
    for row, fn, inputs, iters, prefix in cs.DEVICE_ROWS:
        row[prefix + "device_ms"], row[prefix + "device_kernels"] = cs.device_ms(torch, fn, inputs, iters)
    cs.DEVICE_ROWS.clear()
    print(f"turn D={{d}} " + json.dumps({{name: {{k: row[k] for k in ("device_ms", "library_device_ms", "ms",
                                                                  "library_ms", "device_kernels")}}
                                         for name, row in rows.items()}}), flush=True)
"""

DTYPES = {"bf16": ("bfloat16", 2), "fp32": ("float32", 4)}  # torch dtype name, bytes an element


def ablate(torch, pass_: str, key: str, d: int, only=None) -> None:
    """Time the `pass_` wrapper in `key`'s type at head dim `d` through each
    of its ABLATIONS variants (those named in `only`, and "full", if
    given), after printing each build's registers and spills."""
    import ctypes

    from chip_smoke import SEED, TRAIN, built_kernels, device_ms
    from dalle_pytorch_tpu_torch import kernels
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    src = (kernels.CSRC / "flash_attention.cu").read_text()
    out = REPO / "build" / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    table = ABLATIONS[pass_ + ("_fp32" if key == "fp32" else "")]
    for name, old, new in table:
        if only and name != "full" and name not in only:
            continue
        edits = old if new is None else ((old, new),)  # one edit, or a tuple of them
        if any(a not in src for a, _ in edits):
            print(f"ablate {name}: its text is not in the source, skipped")
            continue
        variant = src
        for a, b in edits:
            variant = variant.replace(a, b) if a else variant
        cu = out / f"{pass_}_{key}_{name}.cu"
        cu.write_text(variant)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate {name}: nvcc failed\n{log}")
        so = out / f"{pass_}_{key}_{name}.so"
        built = built_kernels({"ptxas": log, "path": str(so)})
        print(f"ablate {name} build (registers, spill bytes): " + json.dumps(
            {k: (v.get("registers"), v.get("spill_bytes")) for k, v in built.items() if f"<{d}>" in k}))
        libs[name] = ctypes.CDLL(str(so))
    b, h, n = TRAIN["batch"], TRAIN["heads"], TRAIN["n"]
    dtype = getattr(torch, DTYPES[key][0])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kernels._libs["flash_attention"] = libs["full"]
    sets = []
    for _ in range(3):
        q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
    fn = fa.flash_attention_fwd if pass_ == "fwd" else fa.flash_attention_bwd
    inputs = [s[:3] for s in sets] if pass_ == "fwd" else sets
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            kernels._libs["flash_attention"] = libs[name]
            ms, per_kernel = device_ms(torch, fn, inputs, 30)
            print(f"ablate {pass_} {key} D={d} round {rnd} {name}: {fn.__name__} device {ms:.4f} ms "
                  f"{json.dumps(per_kernel)}", flush=True)
    kernels._libs.pop("flash_attention")


def untimed_rows(torch, F) -> None:
    """fp32 flash attention at D = 64 and 256 (kernel and SDPA, forward and
    backward), the fp32 decode step at MAIN's shape beside SDPA, and the
    step at WIDE_STEP_DIM on the split-K kernel in bf16 and fp32 beside
    SDPA; device ms from torch.profiler."""
    import time

    import chip_smoke as cs
    from dalle_pytorch_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(["flash_attention", "flash_decode", "wide_head"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    attn = {d: cs.time_attention(torch, F, peaks, torch.float32, "fp32", 4, d=d) for d in (64, 256)}
    step = cs.time_decode(torch, peaks, torch.float32, "fp32", 4, "step", 1, [258, 700, 1024, 1281])
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    wide = {key: cs.time_wide_step(torch, F, peaks, cs.nvidia_smi_line(), cs.WIDE_STEP_DIM, g, key, elt)
            for key, elt in cs.WIDE_DTYPES}
    for row, fn, inputs, iters, prefix in cs.DEVICE_ROWS:
        row[prefix + "device_ms"], row[prefix + "device_kernels"] = cs.device_ms(torch, fn, inputs, iters)
    print(f"timed in {time.perf_counter() - t0:.1f} s", flush=True)
    for d, rows in attn.items():
        for name, row in rows.items():
            print(f"rows fp32 {name} D={d}: " + json.dumps(row))
    print("rows fp32 flash_decode step: " + json.dumps(step))
    for key, row in wide.items():
        print(f"rows {key} step D={cs.WIDE_STEP_DIM}: " + json.dumps(row))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="checkout of another commit to time in turns")
    ap.add_argument("--pass", dest="pass_", choices=("fwd", "bwd"), default="bwd",
                    help="the pass --ablate takes apart")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bf16", help="the timed rows' type")
    ap.add_argument("--d", type=int, nargs="+", choices=(64, 256), default=[64],
                    help="the timed rows' head dims")
    ap.add_argument("--ablate", action="store_true", help="time variants without each part")
    ap.add_argument("--only", default="", help="comma-separated ABLATIONS names to build (with full)")
    ap.add_argument("--rows", action="store_true", help="time only the fp32 attention rows and the D = 1032 step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    from chip_smoke import (
        DEVICE_ROWS,
        card_peaks,
        check_attention,
        check_tf32_build,
        device_ms,
        nvidia_smi_line,
        time_attention,
    )
    from dalle_pytorch_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {nvidia_smi_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    if args.rows:
        untimed_rows(torch, F)
        return 0
    kernels.build(["flash_attention"])
    for name, info in kernels.build_log.items():
        print(f"build {name}: {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "error", "wgmma", "Performance")):
                print(f"  ptxas {line.strip()}")
    print("fp32 kernels (ptxas, cuobjdump -sass): "
          + json.dumps(check_tf32_build(kernels.build_log["flash_attention"])), flush=True)
    dtype_name, elt = DTYPES[args.dtype]
    if args.parent is None:
        _, peaks = card_peaks(torch.cuda.get_device_name(0))
        for d in args.d:
            rows = time_attention(torch, F, peaks, getattr(torch, dtype_name), args.dtype, elt, d=d)
            for row, fn, inputs, iters, prefix in DEVICE_ROWS:
                row[prefix + "device_ms"], row[prefix + "device_kernels"] = device_ms(torch, fn, inputs, iters)
            DEVICE_ROWS.clear()
            for name, row in rows.items():
                print(f"device {name} {args.dtype} D={d}: kernel {row['device_ms']:.4f} ms "
                      f"{json.dumps(row['device_kernels'])}, SDPA {row['library_device_ms']:.4f} ms", flush=True)
    check_attention(torch)
    if args.ablate:
        for d in args.d:
            ablate(torch, args.pass_, args.dtype, d, [n for n in args.only.split(",") if n])
    if args.parent is None:
        return 0
    snippet = TIME_ONLY.format(smoke=str(REPO / "chip_smoke.py"), key=args.dtype, elt=elt, dims=args.d)
    for label, cwd in (("parent", args.parent), ("change", REPO), ("change", REPO),
                       ("parent", args.parent)):
        print(f"--- {label} ({cwd})", flush=True)
        res = subprocess.run([sys.executable, "-c", snippet], cwd=cwd, timeout=900)
        if res.returncode != 0:
            print(f"torch_attention_bwd_probe: {label} run failed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
