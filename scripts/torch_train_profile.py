#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one GPU.

Builds the flagship DALLE and batch exactly as `chip_smoke.py` does
(float32 parameters from its seed, bfloat16 autocast, attn_impl "auto",
batch 4 of 1280 tokens, forward_only, Adam with clipping), takes two
warmup steps, times five steps on the host clock (each ending in a
synchronize), then runs three more under `torch.profiler` (CPU and CUDA
activity) and splits that window's wall time into device-busy time per
kernel family and the idle rest.

Run from the repo root on the machine with the card:

    python3 scripts/torch_train_profile.py

Prints the card's nvidia-smi line, then one JSON line.
"""

from __future__ import annotations

import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import flagship_training, nvidia_smi_line  # noqa: E402


def kernel_family(name: str) -> str:
    lowered = name.lower()
    # csrc/flash_attention.cu: the tensor-core forward and fused backward
    # (bf16; the backward's dq conversion beside it) or the CUDA-core
    # forward, dq and dk/dv (fp32)
    port = re.search(r"\b(fwd|dq|dkv|bwd)(_mma)?_kernel<|\b(dq_convert)_kernel\b", lowered)
    if port:
        return f"flash_attention {port.group(1) or port.group(3)} (port kernel)"
    if any(t in lowered for t in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "multi_tensor" in lowered or "foreach" in lowered:
        return "optimizer (foreach)"
    if "memcpy" in lowered or "memset" in lowered:
        return "memcpy / memset"
    if "softmax" in lowered or "logsumexp" in lowered or "nll" in lowered:
        return "softmax / cross-entropy"
    if "reduce" in lowered or "norm" in lowered:
        return "reductions / layernorm"
    if "embedding" in lowered or "index" in lowered or "gather" in lowered or "scatter" in lowered:
        return "embedding / gather / scatter"
    return "elementwise and other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dalle_pytorch_tpu_torch.training.steps import make_dalle_train_step, make_optimizer

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    model, batch = flagship_training()
    opt = make_optimizer(model.parameters(), 3e-4, clip_grad_norm=0.5)
    step = make_dalle_train_step(model, opt, mode="forward_only", autocast_dtype=torch.bfloat16)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step(batch)
        torch.cuda.synchronize()
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    tokens = batch["text"].shape[0] * model.total_seq_len
    print(smi)
    print(json.dumps({
        "step_walls_ms": [1e3 * w for w in walls],
        "median_step_ms": 1e3 * sorted(walls)[len(walls) // 2],
        "tokens_per_s": tokens / sorted(walls)[len(walls) // 2],
        "profiled_steps": n_prof,
        "profiled_wall_s": profiled_wall,
        "device_busy_s": busy if by_name else None,
        "device_idle_share": 1 - busy / profiled_wall if by_name else None,
        "device_launches_per_step": sum(c for _, c in by_name.values()) / n_prof,
        "families": {
            k: {"ms_per_step": 1e3 * t / n_prof, "launches_per_step": c / n_prof,
                "share_of_busy": t / busy}
            for k, (t, c) in sorted(families.items(), key=lambda kv: -kv[1][0])
        },
        "top_kernels": [
            {"name": n[:120], "ms_per_step": 1e3 * t / n_prof, "launches_per_step": c / n_prof}
            for n, (t, c) in top
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
