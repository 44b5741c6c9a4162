#!/usr/bin/env python3
"""The flash-attention kernels alone on one GPU: build, hold against the
plain versions, time.

Builds `csrc/flash_attention.cu` (printing nvcc's register, shared-memory
and spill report for every kernel), runs `chip_smoke.py`'s phase-2 checks
of flash attention (every case: bf16 and fp32, causal, ragged, axial_row,
n_k > n_q, D = 16/32/128) and its phase-3 timing at the training shapes
(causal, B=4, H=16, N=1280, D=64, bf16): kernel, plain version, SDPA,
bound, and the whole backward as the autograd Function runs it (the
timing first, so a failing check still leaves the times printed).

    python3 scripts/torch_attention_bwd_probe.py [--parent DIR] [--ablate]

With --parent DIR (an unpacked checkout of another commit, e.g. the
parent's `git archive` under the git-ignored `build/`), the timing runs in
turns in separate processes, parent, this tree, this tree, parent, so the
two versions are compared on one card in one call. With --ablate, copies
of `csrc/flash_attention.cu` that each drop or change one part of the
fused backward (`ABLATIONS`; the results are wrong, only their times
count) are built into `build/ablate/` and the backward wrapper is timed
through each, in two rounds of opposite order: what each part costs.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# (variant, text in csrc/flash_attention.cu, its replacement)
ABLATIONS = (
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
)

TIME_ONLY = """
import sys, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
from chip_smoke import card_peaks, time_attention
from dalle_pytorch_tpu_torch import kernels
kernels.build(["flash_attention"])
_, peaks = card_peaks(torch.cuda.get_device_name(0))
time_attention(torch, F, peaks, torch.bfloat16, "bf16", 2)
"""


def ablate(torch) -> None:
    """Time the backward wrapper through each ABLATIONS variant."""
    import ctypes

    from chip_smoke import SEED, TRAIN, time_ms
    from dalle_pytorch_tpu_torch import kernels
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    src = (kernels.CSRC / "flash_attention.cu").read_text()
    out = REPO / "build" / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    for name, old, new in ABLATIONS:
        if old not in src:
            print(f"ablate {name}: its text is not in the source, skipped")
            continue
        cu = out / f"{name}.cu"
        cu.write_text(src.replace(old, new) if old else src)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    b, h, n, d = TRAIN["batch"], TRAIN["heads"], TRAIN["n"], TRAIN["dim_head"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kernels._libs["flash_attention"] = libs["full"]
    sets = []
    for _ in range(3):
        q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").bfloat16() for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            kernels._libs["flash_attention"] = libs[name]
            ms = time_ms(torch, fa.flash_attention_bwd, sets, 60)
            print(f"ablate round {rnd} {name}: flash_attention_bwd {ms:.4f} ms")
    kernels._libs.pop("flash_attention")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="checkout of another commit to time in turns")
    ap.add_argument("--ablate", action="store_true", help="time variants without each part")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    from chip_smoke import card_peaks, check_attention, nvidia_smi_line, time_attention
    from dalle_pytorch_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.build(["flash_attention"])
    for name, info in kernels.build_log.items():
        print(f"build {name}: {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "error")):
                print(f"  ptxas {line.strip()}")
    if args.parent is None:
        _, peaks = card_peaks(torch.cuda.get_device_name(0))
        time_attention(torch, F, peaks, torch.bfloat16, "bf16", 2)
    check_attention(torch)
    if args.ablate:
        ablate(torch)
    if args.parent is None:
        return 0
    for label, cwd in (("parent", args.parent), ("change", REPO), ("change", REPO),
                       ("parent", args.parent)):
        print(f"--- {label} ({cwd})", flush=True)
        res = subprocess.run([sys.executable, "-c", TIME_ONLY], cwd=cwd, timeout=600)
        if res.returncode != 0:
            print(f"torch_attention_bwd_probe: {label} run failed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
