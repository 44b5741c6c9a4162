#!/usr/bin/env python3
"""Where the time goes in the port's continuous-serving path, on one GPU.

Builds phase 5's flagship model and dVAE as `chip_smoke.py` does (random
weights from its seed, bfloat16), then for each engine configuration of
`chip_smoke.py` phase 7 (causal, int8 KV, policy sparsity, and policy +
int8 on the full / axial_row / axial_col / conv_like model): a warmed
`ContinuousEngine` with 4 slots and chunks of 4 tokens, all four slots
admitted, 10 chunks timed on the host clock (`step_chunk` ends in the
chunk-boundary snapshot, so the device work is done), then 10 more under
`torch.profiler` (CPU and CUDA activity), split into device-busy time per
kernel family and the idle rest.

With `--kv_layout paged` the engine is a `PagedContinuousEngine` (page
32, the default pool) reading its pages through `--paged_decode_impl`
("gather": paged_gather + the contiguous kernels; "kernel": the paged
kernels), as `chip_smoke.py` phase 8 runs it.

Run from the repo root on the machine with the card:

    python3 scripts/torch_continuous_profile.py
    python3 scripts/torch_continuous_profile.py --kv_layout paged --paged_decode_impl kernel

Prints the card's nvidia-smi line, then one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (  # noqa: E402
    CONTINUOUS,
    FLAGSHIP,
    PAGE,
    PATTERNED,
    SEED,
    flagship_engine,
    nvidia_smi_line,
)
from torch_generate_profile import kernel_family  # noqa: E402

CHUNKS = 10


def family(name: str) -> str:
    """kernel_family, with the flash-decode variants told apart by their
    template arguments (KV type, SPARSE, PAGED)."""
    if "flash_decode_kernel" in name:
        args = name.split("flash_decode_kernel<", 1)[1].split(">", 1)[0].split(", ")
        sparse, paged = (flag == "true" for flag in args[-2:])
        kind = ("block_sparse_" if sparse else "") + ("paged_" if paged else "") + "flash_decode"
        return kind + (" int8" if "signed char" in name else "") + " (port kernel)"
    return kernel_family(name)


def profile_config(torch, model, vae, specs, label, layout, **options):
    from torch.profiler import ProfilerActivity, profile

    from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, PagedContinuousEngine

    if layout["kv_layout"] == "paged":
        engine = PagedContinuousEngine(
            model, vae, **CONTINUOUS, page_size=PAGE, device="cuda",
            paged_decode_impl=layout["paged_decode_impl"], **options,
        )
    else:
        engine = ContinuousEngine(model, vae, **CONTINUOUS, device="cuda", **options)
    engine.warmup()
    engine.prefill_slots(list(enumerate(specs)))
    walls = []
    for _ in range(CHUNKS):
        t0 = time.perf_counter()
        engine.step_chunk()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CHUNKS):
            engine.step_chunk()
        profiled_wall = time.perf_counter() - t0
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e6
            by_name[evt.name][1] += 1
    busy = sum(t for t, _ in by_name.values())
    families = defaultdict(lambda: [0.0, 0])
    for name, (t, c) in by_name.items():
        fam = families[family(name)]
        fam[0] += t
        fam[1] += c
    launches = sum(c for _, c in by_name.values())
    return {
        "config": label,
        **layout,
        "ms_per_chunk": 1e3 * statistics.median(walls),
        "ms_per_token_step": 1e3 * statistics.median(walls) / CONTINUOUS["chunk_tokens"],
        "profiled_wall_s": profiled_wall,
        "device_busy_s": busy if by_name else None,
        "device_idle_share": 1 - busy / profiled_wall if by_name else None,
        "device_launches_per_chunk": launches / CHUNKS,
        "families": {
            k: {"s": t, "launches_per_chunk": c / CHUNKS, "share_of_busy": t / busy}
            for k, (t, c) in sorted(families.items(), key=lambda kv: -kv[1][0])
        },
        "sparsity": engine.sparsity_detail(),
    }


def main() -> int:
    import torch

    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kv_layout", choices=("slot", "paged"), default="slot")
    parser.add_argument("--paged_decode_impl", choices=("gather", "kernel"), default="kernel")
    args = parser.parse_args()
    layout = {"kv_layout": args.kv_layout}
    if args.kv_layout == "paged":
        layout["paged_decode_impl"] = args.paged_decode_impl
    if not torch.cuda.is_available():
        print("torch_continuous_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    engine, specs, _ = flagship_engine()
    model, vae = engine.model, engine.vae
    del engine
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        patterned = DALLE(**{**FLAGSHIP, "attn_types": PATTERNED}).to(torch.bfloat16).eval()
    print(smi)
    for label, m, options in (
        ("causal", model, {}),
        ("int8", model, dict(kv_dtype="int8")),
        ("policy", model, dict(decode_sparsity="policy")),
        ("policy+int8 patterned", patterned, dict(decode_sparsity="policy", kv_dtype="int8")),
    ):
        print(json.dumps(profile_config(torch, m, vae, specs, label, layout, **options)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
