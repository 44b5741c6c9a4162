#!/usr/bin/env python3
"""Build and check the head-dim > 256 kernels (`csrc/wide_head.cu`) alone,
on one NVIDIA GPU, from the root of a checkout:

    python3 scripts/torch_wide_head_probe.py [--time]

Builds `wide_head.cu` by itself (ptxas registers, spills and shared
memory of each kernel), then runs `chip_smoke.py`'s phase-2 checks of the
wide kernels (the routing of D = 264, 320, 1024; the five decode variants
at D = 264-1024 with the bit identities at 320 and NaN-poisoned caches;
flash attention forward and backward on the causal, all-keys and
static-mask arms at D = 264-512) and phase 4's small models at dim_head
320 through the kernels against dense attention. `--time` adds phase 3's
times of the wide kernels at D = 320 and 512 (CUDA events, the plain
version, SDPA, the bound, and the device time from a torch.profiler
trace). About half a minute of card time, a minute with `--time`.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_wide_head_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dalle_pytorch_tpu_torch import kernels

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--time", action="store_true", help="also time the wide kernels")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.build(["wide_head"])
    info = kernels.build_log["wide_head"]
    print(f"build wide_head: {time.perf_counter() - t0:.2f} s -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if re.search(r"Compiling entry|registers|spill|smem", line):
            print("  ptxas " + line.strip())

    t0 = time.perf_counter()
    cs.check_head_dim_limit(torch)
    worst, held = cs.check_wide_decode(torch)
    attn = cs.check_wide_attention(torch)
    cs.check_small_model_decode(torch, cs.WIDE_IDENTITY_DIM)
    cs.check_small_model_training(torch, cs.WIDE_IDENTITY_DIM)
    print(f"checks: {time.perf_counter() - t0:.1f} s; worst bf16 decode err {worst:.3e}, "
          f"attention {json.dumps(attn)}, identities {json.dumps(held)}")
    if args.time:
        rows = cs.time_wide_kernels(torch, F, peaks, smi)
        for row, fn, inputs, iters in cs.DEVICE_ROWS:
            row["device_ms"], row["device_kernels"] = cs.device_ms(torch, fn, inputs, iters)
        print("wide times " + json.dumps(rows))
    print(json.dumps({"ok": True, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
