#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one GPU.

Builds the flagship micro GenerationEngine exactly as `chip_smoke.py` does
(random weights from its seed, bfloat16, batch 4, dVAE fused), warms it,
times `generate()` of the four prompts three times on the host clock (the
call returns numpy arrays, so the device work is done), then runs it once
more under `torch.profiler` (CPU and CUDA activity) and splits that run's
wall time into device-busy time per kernel and the idle rest.

Run from the repo root on the machine with the card:

    python3 scripts/torch_generate_profile.py

Prints the card's nvidia-smi line, then one JSON line.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import flagship_engine, nvidia_smi_line  # noqa: E402


def kernel_family(name: str) -> str:
    lowered = name.lower()
    if "flash_decode" in lowered:
        return "flash_decode (port kernel)"
    if any(t in lowered for t in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "conv" in lowered or "cudnn" in lowered:
        return "convolution (cuDNN)"
    if any(t in lowered for t in ("sort", "topk", "radix", "bitonic")):
        return "top-k / sort"
    if "memcpy" in lowered or "memset" in lowered:
        return "memcpy / memset"
    if "rand" in lowered or "philox" in lowered or "distribution" in lowered:
        return "random"
    if "reduce" in lowered or "norm" in lowered:
        return "reductions / layernorm"
    return "elementwise and other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_generate_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    engine, specs, _ = flagship_engine()
    engine.warmup()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.generate(specs)
        walls.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(specs)
        profiled_wall = time.perf_counter() - t0

    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        # device kernels only: a user annotation (e.g. "Optimizer.step#...")
        # spans kernels already counted
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e6
            by_name[evt.name][1] += 1
    busy = sum(t for t, _ in by_name.values())
    families = defaultdict(lambda: [0.0, 0])
    for name, (t, c) in by_name.items():
        fam = families[kernel_family(name)]
        fam[0] += t
        fam[1] += c
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    steps = 1 + engine.image_seq_len
    print(smi)
    print(json.dumps({
        "walls_s": walls,
        "median_wall_s": statistics.median(walls),
        "images_per_s": len(specs) / statistics.median(walls),
        "host_ms_per_decode_step": 1e3 * statistics.median(walls) / steps,
        "profiled_wall_s": profiled_wall,
        "device_busy_s": busy if by_name else None,
        "device_idle_share": 1 - busy / profiled_wall if by_name else None,
        "device_launches": sum(c for _, c in by_name.values()),
        "families": {
            k: {"s": t, "launches": c, "share_of_busy": t / busy}
            for k, (t, c) in sorted(families.items(), key=lambda kv: -kv[1][0])
        },
        "top_kernels": [
            {"name": n[:120], "s": t, "launches": c} for n, (t, c) in top
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
