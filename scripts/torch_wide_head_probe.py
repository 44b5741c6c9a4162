#!/usr/bin/env python3
"""Build, check and time the head-dim > 256 kernels (`csrc/wide_head.cu`,
`csrc/wide_decode_tile.cu`) alone, on one NVIDIA GPU, from the root of a
checkout:

    python3 scripts/torch_wide_head_probe.py [--time] [--ablate] [--ablate-tile] [--parent DIR]

Builds the two sources by themselves and prints ptxas's registers, spills
and shared memory of each kernel and the tensor-core instructions (HMMA)
that `cuobjdump -sass` finds in each bf16 flash-attention kernel and each
decode tile instance (it fails if one spills or has none). Then runs
`chip_smoke.py`'s phase-2 checks of the
wide kernels (the routing of D = 264, 300, 320 and 1024; the five decode
variants at D = 264-1024 with the bit identities at 320 and NaN-poisoned
caches, the tile kernel at the resume shape; flash attention forward and
backward on the causal, all-keys and
static-mask arms at D = 264-1024, and causal at the training shapes at D =
320 and 512) and phase 4's small models at dim_head 320 through the
kernels against dense attention (decode in fp32 and bf16). About a minute
of card time.

`--time` adds phase 3's times of the wide kernels at D = 320 and 512, bf16
and fp32 (CUDA events, the plain version, SDPA, the bound at the input
type's peak, and the device times of the kernel and of SDPA from
torch.profiler traces): the decode step, the multi-row decode at the
resume and prefill shapes, flash attention forward and backward at the
training shapes. `--ablate` times the bf16 flash-attention forward and
backward at the training shapes through variants (`ABLATIONS`): copies of
`csrc/wide_head.cu` that each change one part, and the other column plans
(the forward at 128 or 192 columns a block, the backward at 64), device
ms from a trace. `--ablate-tile` does the same for the decode tile kernel
of `csrc/wide_decode_tile.cu` at the resume shape (`TILE_ABLATIONS`: no
copies, one P product where the kernel multiplies P's bf16 pair, no
score products, a deeper ring, Q streamed at every D). With `--parent DIR` (an unpacked
checkout of another commit under the git-ignored `build/`) only the timed
rows run (the flash-attention forward and backward at the training shapes,
the decode step and the multi-row decode at the resume shape, bf16, at D =
320 and 512, beside SDPA), in separate
processes in turns: DIR's kernels and wrappers, this tree's, this tree's,
DIR's (this script's measuring code each time); a last JSON line gives
each turn's device ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TIMED_DIMS = (320, 512)


def load_smoke():
    """This tree's chip_smoke.py as a module, whichever package is first on
    sys.path (its helpers import the port lazily, inside each function)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_report(cs) -> None:
    """ptxas's lines and the HMMA count of each tensor-core kernel."""
    from dalle_pytorch_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(["wide_head", "wide_decode_tile"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, check in (("wide_head", cs.check_wide_build), ("wide_decode_tile", cs.check_wide_tile_build)):
        info = kernels.build_log[name]
        print(f"build {name}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if re.search(r"Compiling entry|registers|spill|smem", line):
                print("  ptxas " + line.strip())
        print(f"{name} checks " + json.dumps(check(info)))


def timed_jobs(torch, F):
    """{row: (fn, inputs, iters)}: the wide flash-attention forward and
    backward (bf16, causal, TRAIN's shapes) at TIMED_DIMS, and SDPA's; the
    decode step (bf16, n = 1, B = 4, H = 16, S = 1281, lengths [258, 700,
    1024, 1281], three input sets rotating) at TIMED_DIMS, and SDPA over
    the cache with the length mask; the multi-row decode at the resume
    shape (bf16, n = 1280, S = 1281, lengths 1280, two input sets) at
    TIMED_DIMS, and SDPA's causal forward over the live keys."""
    import chip_smoke as cs
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    b, h, n = cs.TRAIN["batch"], cs.TRAIN["heads"], cs.TRAIN["n"]
    s_len, lens = cs.MAIN["cache"], torch.tensor([258, 700, 1024, 1281], dtype=torch.int32, device="cuda")
    mask = (torch.arange(s_len, device="cuda")[None, :] <= lens.long()[:, None] - 1)[:, None, None, :]

    def sdpa_masked(q, k, v, lengths):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    jobs = {}
    for d in TIMED_DIMS:
        steps = [tuple(torch.randn(shape, generator=g, device="cuda").bfloat16()
                       for shape in ((b, cs.MAIN["heads"], 1, d), (b, cs.MAIN["heads"], s_len, d),
                                     (b, cs.MAIN["heads"], s_len, d))) + (lens,) for _ in range(3)]
        jobs[f"decode_d{d}"] = (fd.flash_decode_attention, steps, 60)
        jobs[f"sdpa_decode_d{d}"] = (sdpa_masked, steps, 60)
        resume = cs.resume_inputs(torch, b, torch.bfloat16, copies=2, d=d)
        jobs[f"resume_d{d}"] = (fd.flash_decode_attention, resume, 4)
        jobs[f"sdpa_resume_d{d}"] = (
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            [(q, k[:, :, :q.shape[2]].contiguous(), v[:, :, :q.shape[2]].contiguous()) for q, k, v, _ in resume],
            10)
    for d in TIMED_DIMS:
        sets = []
        for _ in range(2):
            q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").bfloat16() for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v)
            sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        jobs[f"fwd_d{d}"] = (fa.flash_attention_fwd, [s[:3] for s in sets], 4)
        jobs[f"bwd_d{d}"] = (fa.flash_attention_bwd, sets, 4)
        jobs[f"sdpa_fwd_d{d}"] = (sdpa, [s[:3] for s in sets], 10)
    return jobs


def timed_rows(torch, cs, jobs):
    """{row: {"event_ms", "device_ms", "device_kernels"}}."""
    rows = {name: dict(event_ms=cs.time_ms(torch, fn, inputs, iters))
            for name, (fn, inputs, iters) in jobs.items()}
    for name, (fn, inputs, iters) in jobs.items():  # traces last: they slow later launches
        rows[name]["device_ms"], rows[name]["device_kernels"] = cs.device_ms(torch, fn, inputs, iters)
    return rows


# (variant, [(text in csrc/wide_head.cu, its replacement), ...], {name in
# ops/wide_head.py: its value while the variant runs}); every occurrence is
# replaced; the variants that drop a part give wrong results and count
# only for their times. The plan variants add the instances the plan does
# not reach and lower its column cap.
STAGES = "constexpr int kFwdStages = 3, kFwdResStages = 4, kBwdStages = 3;"
FWD_CASE = "    case 192: return launch_fwd_mma<192>(a, groups);\n"
BWD_CASE = ("  if (a.cols != 128) return cudaErrorInvalidValue;\n"
            "  err = a.resident ? launch_bwd_mma<128, true>(a, groups) : launch_bwd_mma<128, false>(a, groups);\n")
ABLATIONS = (
    ("source", [], {}),
    ("streaming", [], {"mma_resident": lambda kind, cols, d: False}),
    ("stages_minus_one", [(STAGES, "constexpr int kFwdStages = 2, kFwdResStages = 3, kBwdStages = 2;")],
     {"FWD_STAGES": 2, "FWD_RES_STAGES": 3, "BWD_STAGES": 2}),
    ("stages_plus_one", [(STAGES, "constexpr int kFwdStages = 4, kFwdResStages = 5, kBwdStages = 4;")],
     {"FWD_STAGES": 4, "FWD_RES_STAGES": 5, "BWD_STAGES": 4}),
    ("no_copies", [("    cp_async16(dst + r * ld + c, ok ? src + (size_t)(row0 + r) * D + c0 + c : src, ok);\n",
                    "    (void)ok;\n")], {}),
    ("no_score_products", [
        ("        chunk_product<8>(s, qres + c * kT, ldq, r0, st, kLdt, 0, lane);\n", "        ;\n"),
        ("        chunk_product<8>(s, st + kTileElems, kLdt, r0, st, kLdt, 0, lane);\n", "        ;\n"),
        ("      chunk_product<4>(s, ka, RES ? ld : kLdt, kr, st, kLdt, qh, lane);\n", ""),
        ("      chunk_product<4>(dp, va, RES ? ld : kLdt, kr, st + kTileElems, kLdt, qh, lane);\n", "")], {}),
    ("plan_fwd_cols128", [(FWD_CASE, "    case 128: return launch_fwd_mma<128>(a, groups);\n" + FWD_CASE)],
     {"MMA_COLS": {"fwd": (128, 192, 256), "bwd": (128,)}, "MMA_MAX_COLS": {"fwd": 128, "bwd": 128}}),
    ("plan_fwd_cols192", [], {"MMA_MAX_COLS": {"fwd": 192, "bwd": 128}}),
    ("plan_bwd_cols64", [(BWD_CASE, BWD_CASE.replace("a.cols != 128", "a.cols != 128 && a.cols != 64")
                          .replace("  err = a.resident", "  err = a.cols == 64 ? (a.resident ? launch_bwd_mma<64, "
                                   "true>(a, groups) : launch_bwd_mma<64, false>(a, groups)) : a.resident"))],
     {"MMA_COLS": {"fwd": (192, 256), "bwd": (64, 128)}, "MMA_MAX_COLS": {"fwd": 256, "bwd": 64}}),
)


# the same for the decode tile kernel (`--ablate-tile`, csrc/wide_decode_tile.cu),
# timed at the resume shape; "streaming" keeps the source and streams Q at
# every D (`ablate` swaps the plan)
TILE_STAGES = "constexpr int kStages = 3, kResStages = 4;"
TILE_ABLATIONS = (
    ("source", [], {}),
    ("no_copies", [("        cp_async16(to + pass * ROWS * ld_bytes, ok ? from + row * (D * ELT) : from, ok);\n",
                    "        (void)ok;\n")], {}),
    ("one_p_product", [("      mma_bf16(c0, lo[kc], bf[0], bf[1]);\n      mma_bf16(c1, lo[kc], bf[2], bf[3]);\n", "")],
     {}),
    ("no_score_products", [("          chunk_product(s, qres + c * kT, ldq, r0, kt_tile, lane);\n", "          ;\n"),
                           ("          chunk_product(s, st + kTileElems, kLdt, r0, kt_tile, lane);\n", "          ;\n")],
     {}),
    ("stages_plus_one", [(TILE_STAGES, "constexpr int kStages = 4, kResStages = 5;")],
     {"TILE_STAGES": 4, "TILE_RES_STAGES": 5}),
    ("streaming", [], {"wide_tile_plan": "streaming"}),
    ("no_mask_select", [("      const bool full = key0 + kT - 1 <= wbound0 && live == ~0ull;\n",
                         "      const bool full = live == ~0ull || true;\n")], {}),
)


def ablate(torch, cs, F, source="wide_head", variants=ABLATIONS, prefixes=("fwd", "bwd")) -> None:
    """Device ms of the timed jobs named by `prefixes` (the bf16 forward and
    backward at TIMED_DIMS; the resume-shape decode for the tile source)
    through each variant of `variants` (a copy of `csrc/<source>.cu` and
    the wrapper's names it sets), two rounds in opposite order."""
    import ctypes

    from dalle_pytorch_tpu_torch import kernels
    from dalle_pytorch_tpu_torch.ops import wide_head as wh

    plan = wh.wide_tile_plan

    def plan_streaming(d, quant=False):
        full = plan(d, quant)
        return wh.WidePlan("tile", d, full.cols, full.groups, full.chunks, False, wh.wide_tile_smem(d, False, quant))

    variants = tuple((name, edits, {k: plan_streaming if v == "streaming" else v for k, v in patch.items()})
                     for name, edits, patch in variants)
    src = (kernels.CSRC / f"{source}.cu").read_text()
    out = REPO / "build" / f"ablate_{source}"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    for name, edits, _ in variants:
        if any(old not in src for old, _ in edits):
            raise RuntimeError(f"ablate {name}: its text is not in the source")
        variant = src
        for old, new in edits:
            variant = variant.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(variant)
        procs[name] = subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate {name}: nvcc failed\n{log}")
        regs = re.findall(r"Compiling entry function '([^']*_kernel[^']*)'[^\n]*\n(?:[^\n]*\n){0,3}?[^\n]*Used (\d+) registers",
                          log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(json.dumps({"ablate": name, "registers": {cs.mangled_kernel(k): int(r) for k, r in regs},
                          "spill_store_bytes": sum(map(int, spills))}), flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    jobs = {k: job for k, job in timed_jobs(torch, F).items() if k.startswith(prefixes)}

    patches = {name: patch for name, _, patch in variants}
    saved = {attr: getattr(wh, attr) for patch in patches.values() for attr in patch}
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            kernels._libs[source] = libs[name]
            for attr, value in {**saved, **patches[name]}.items():
                setattr(wh, attr, value)
            if source == "wide_head":
                plans = {f"{kind}_d{d}": wh.wide_attention_plan(d, kind).kernel
                         for d in TIMED_DIMS for kind in ("fwd", "bwd")}
            else:
                plans = {f"resume_d{d}": wh.wide_tile_plan(d).kernel for d in TIMED_DIMS}
            row = {job: cs.device_ms(torch, fn, inputs, iters)[0] for job, (fn, inputs, iters) in jobs.items()}
            print(json.dumps({"ablate": name, "round": rnd, "device_ms": row, "plans": plans}), flush=True)
    for attr, value in saved.items():
        setattr(wh, attr, value)
    kernels._libs.pop(source)


def in_turns(parent: str) -> int:
    """The timed rows of DIR's kernels and this tree's, in turns."""
    turns = []
    for label, tree in (("parent", Path(parent).resolve()), ("change", REPO), ("change", REPO),
                        ("parent", Path(parent).resolve())):
        print(f"--- {label} ({tree})", flush=True)
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree)],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            print(f"torch_wide_head_probe: {label} run failed", file=sys.stderr)
            return 1
        rows = json.loads(res.stdout.strip().splitlines()[-1])["rows"]
        turns.append({"tree": label, **{k: r["device_ms"] for k, r in rows.items()}})
    print(json.dumps({"device_ms_turns": turns}))
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--time", action="store_true", help="also time the wide kernels (phase 3)")
    p.add_argument("--ablate", action="store_true", help="time copies of the source without each part")
    p.add_argument("--ablate-tile", action="store_true",
                   help="the same for the decode tile kernel (csrc/wide_decode_tile.cu) at the resume shape")
    p.add_argument("--parent", default=None, help="checkout of another commit to time in turns")
    p.add_argument("--tree", default=None, help="time this checkout's kernels (used by --parent)")
    args = p.parse_args()
    if args.parent is not None:
        return in_turns(args.parent)
    sys.path.insert(0, str(Path(args.tree).resolve() if args.tree else REPO))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_wide_head_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke()
    sys.modules.setdefault("chip_smoke", cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    if args.tree is not None:  # one turn of --parent: the timed rows only
        rows = timed_rows(torch, cs, timed_jobs(torch, F))
        print(json.dumps({"card": smi, "rows": rows}))
        return 0
    if args.ablate or args.ablate_tile:
        if args.ablate:
            ablate(torch, cs, F)
        if args.ablate_tile:
            ablate(torch, cs, F, "wide_decode_tile", TILE_ABLATIONS, ("resume",))
        print(smi)
        return 0
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernel_report(cs)
    t0 = time.perf_counter()
    cs.check_head_dim_limit(torch)
    worst, held = cs.check_wide_decode(torch)
    attn = cs.check_wide_attention(torch)
    cs.check_small_model_decode(torch, cs.WIDE_IDENTITY_DIM)
    cs.check_small_model_decode(torch, cs.WIDE_IDENTITY_DIM, torch.bfloat16)
    cs.check_small_model_training(torch, cs.WIDE_IDENTITY_DIM)
    print(f"checks: {time.perf_counter() - t0:.1f} s; worst decode err by arm {json.dumps(worst)}, "
          f"attention {json.dumps(attn)}, identities {json.dumps(held)}")
    if args.time:
        t0 = time.perf_counter()
        rows = cs.time_wide_kernels(torch, F, peaks, smi)
        for row, fn, inputs, iters, prefix in cs.DEVICE_ROWS:
            row[prefix + "device_ms"], row[prefix + "device_kernels"] = cs.device_ms(torch, fn, inputs, iters)
        cs.DEVICE_ROWS.clear()
        print(f"times: {time.perf_counter() - t0:.1f} s")
        print("wide times " + json.dumps({kernel: {"/".join(map(str, case)): row for case, row in cases.items()}
                                          for kernel, cases in rows.items()}))
    print(smi)
    print(json.dumps({"ok": True, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
