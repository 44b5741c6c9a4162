#!/usr/bin/env python3
"""`chip_smoke.py` phase 12 (the trainer twin at the flagship width) alone,
on one GPU, with a breakdown of its wall time.

Builds the four kernel sources the trainer's path runs (flash attention
for the step, flash decode and its two multi-row arms for the in-loop
sample), then runs `chip_smoke.run_trainer` (the dVAE encode check, run A
and run B, every check of the phase) with the trainer's pieces timed:
the model build, the exports (`save_dalle_checkpoint`), the host copies
of the parameters and of the Adam state, the step checkpoint's restore
and loads, and the sample (ended by a synchronize).

Run from the repo root on the machine with the card:

    python3 scripts/torch_trainer_probe.py

Prints the card's nvidia-smi line, the build time, phase 12's own lines
and wall, then `breakdown {...}`: seconds spent in each timed piece over
both runs (a piece called inside another is counted in both).
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TIMED = ("dalle_from_config", "save_dalle_checkpoint", "export_dalle_params",
         "export_dalle_opt_state", "load_dalle_params", "load_dalle_opt_state",
         "build_dataset", "build_vae", "build_tokenizer", "restore_opt_state")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_trainer_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from dalle_pytorch_tpu_torch import kernels, train_dalle
    from dalle_pytorch_tpu_torch.training import checkpoint

    smi = chip_smoke.nvidia_smi_line()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.build(["flash_decode", "flash_decode_tile", "flash_decode_tile_f32", "flash_attention"])
    print(f"build {time.perf_counter() - t0:.1f} s")

    spent = collections.defaultdict(float)

    def timed(owner, name, sync=False):
        fn = getattr(owner, name)

        def wrap(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out

        setattr(owner, name, wrap)

    for name in TIMED:
        timed(train_dalle, name)
    timed(train_dalle, "generate_images_cached", sync=True)
    timed(checkpoint.CheckpointManager, "restore")
    timed(checkpoint.CheckpointManager, "wait")
    t0 = time.perf_counter()
    chip_smoke.run_trainer(torch, smi)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    print("breakdown " + json.dumps(spent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
