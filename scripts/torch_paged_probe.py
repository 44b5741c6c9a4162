#!/usr/bin/env python3
"""The paged flash-decode kernel against kernel 1, by page size and table
order, on one GPU.

At the flagship decode step (n = 1, B = 4, H = 16, D = 64, bf16, lengths
[258, 700, 1024, 1281]) and for pages of 16, 32, 64 and 128 positions,
times with CUDA events (12 input copies rotating, as `chip_smoke.py`
does): kernel 1 on the contiguous view gathered beforehand, the paged
kernel through a shuffled table (rows sharing pages), and the paged kernel
through an in-order table (row b's block j at page 1 + b * n_pages + j),
so a difference between the last two is the table's order and one between
them and kernel 1 is the paged kernel's own. Checks that the paged kernel
equals kernel 1 on the gathered view bit for bit.

Run from the repo root on the machine with the card:

    python3 scripts/torch_paged_probe.py

Prints one JSON line per page size, then the card's nvidia-smi line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import LAYERS, MAIN, nvidia_smi_line, paged_case, time_ms  # noqa: E402

LENGTHS = [258, 700, 1024, 1281]


def main() -> int:
    import torch

    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    if not torch.cuda.is_available():
        print("torch_paged_probe: no CUDA device", file=sys.stderr)
        return 1
    vlen, iters = MAIN["cache"], 40 * LAYERS
    for page in (16, 32, 64, 128):
        n_pages = -(-vlen // page)
        shuffled = [
            paged_case(torch, 4, MAIN["heads"], 1, MAIN["dim_head"], page, LENGTHS,
                       torch.bfloat16, vlen, seed)[:5]
            for seed in range(LAYERS)
        ]
        in_order = torch.arange(1, 1 + 4 * n_pages, dtype=torch.int32, device="cuda").view(4, n_pages)
        ordered = [(q, k, v, lens, in_order) for q, k, v, lens, _ in shuffled]
        gathered = [
            (q, fd.paged_gather(k, t, vlen), fd.paged_gather(v, t, vlen), lens)
            for q, k, v, lens, t in shuffled
        ]
        same = all(
            torch.equal(fd.paged_flash_decode_attention(*p), fd.flash_decode_attention(*g))
            for p, g in zip(shuffled, gathered)
        )
        row = dict(
            page=page,
            kernel1_ms=time_ms(torch, fd.flash_decode_attention, gathered, iters),
            paged_shuffled_ms=time_ms(torch, fd.paged_flash_decode_attention, shuffled, iters),
            paged_in_order_ms=time_ms(torch, fd.paged_flash_decode_attention, ordered, iters),
            paged_equals_kernel1=same,
        )
        print(json.dumps(row), flush=True)
        if not same:
            print("torch_paged_probe: the paged kernel differs from kernel 1", file=sys.stderr)
            return 1
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
