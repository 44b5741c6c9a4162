#!/usr/bin/env python3
"""Phase 10's resume at a chosen drain, on one GPU, for one checkout's
kernels: a witness for the token rule of `chip_smoke.py` (ROADMAP Queue 3).

    python3 scripts/torch_resume_witness.py [--tree DIR] [--drain-at 516]

Builds the flagship micro engine (bf16, batch 4, random weights from the
seed) and takes its tokens as the uninterrupted run, then runs
`chip_smoke.serve_migrated` on the slotted causal engine under
`drain_at_fixed_chunks` with DRAIN_AT = `--drain-at` (516 drains rows 0-1
at 548 and rows 2-3 at 516). With `--tree DIR` (an unpacked checkout of
another commit under the git-ignored `build/`) the package and kernels
are DIR's, the measuring code this tree's. Beside the migrated summary
(first divergence and first sub-margin position of each row under the
rule), it prints each row's noised margins at positions 545-552 under the
rule and under a threshold-aware reading (`threshold_margins`: a token
whose logit lies within RESUME_LOGIT_TOL of the top-k threshold competes
for the gap, and a position where such a token holds the best noised
score has margin 0). The summary's checks may fail (DIR's launch counters
differ); the last JSON line says whether they held. About two minutes of
card time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def threshold_margins(torch, model, specs, tokens, tol):
    """[R, image_seq_len] noised top-2 gaps as `chip_smoke.noised_margins`
    forms them, where tokens within `tol` of a row's top-k threshold
    compete whether kept or not, and a row whose best noised score is such
    a token has gap 0."""
    import numpy as np

    from dalle_pytorch_tpu_torch.models.dalle import NEG_MASK_VALUE
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise, keep_count

    dev = model.text_emb.weight.device
    text = torch.tensor(np.stack([s.text_ids for s in specs]), device=dev)
    seeds = [int(s.seed) & 0x7FFFFFFF for s in specs]
    temps = torch.tensor([float(s.temperature) for s in specs], device=dev).clamp(min=1e-4)[:, None]
    keep = torch.tensor([keep_count(min(max(float(s.top_k), 0.0), 1.0), model.total_tokens)
                         for s in specs], device=dev)
    blocked = (torch.arange(model.total_tokens, device=dev) < model.total_text_tokens)[None]
    margins = torch.zeros(tokens.shape, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        _, out = model.trunk(text, torch.tensor(tokens, device=dev))
        for p in range(model.image_seq_len):
            row = model.to_logits(out[:, model.text_seq_len + p]).float().masked_fill(blocked, NEG_MASK_VALUE)
            kth = torch.topk(row, int(keep.max()), dim=-1).values.gather(-1, keep[:, None] - 1)
            near = (row - kth).abs() <= tol
            scores = torch.where((row >= kth) | near, row / temps + gumbel_noise(seeds, p, row.shape[-1], dev),
                                 torch.full_like(row, float("-inf")))
            best = torch.topk(scores, 2, dim=-1)
            gap = best.values[:, 0] - best.values[:, 1]
            margins[:, p] = torch.where(near.gather(-1, best.indices[:, :1])[:, 0], 0.0, gap)
    return margins.cpu().numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="checkout whose package and kernels to run")
    ap.add_argument("--drain-at", type=int, default=516, help="chip_smoke.DRAIN_AT for the drain")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() if args.tree else REPO))

    import torch

    if not torch.cuda.is_available():
        print("torch_resume_witness: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import dalle_pytorch_tpu_torch
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    for name in ("flash_decode_attention", "paged_flash_decode_attention"):
        for attr in ("tile_launches", "tile_int8_launches"):  # absent before the tile arm
            if not hasattr(getattr(fd, name), attr):
                setattr(getattr(fd, name), attr, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(f"card: {smi}; package {dalle_pytorch_tpu_torch.__file__}", flush=True)
    t0 = time.perf_counter()
    engine, specs, _ = cs.flagship_engine()
    engine.warmup()
    reference, _ = engine.generate(specs)
    print(f"uninterrupted run: {time.perf_counter() - t0:.1f} s", flush=True)
    vae, model = engine.vae, engine.model
    del engine

    rule = cs.noised_margins

    def reporting_margins(torch_, model_, specs_, tokens):
        margins = rule(torch_, model_, specs_, tokens)
        near = threshold_margins(torch_, model_, specs_, tokens, cs.RESUME_LOGIT_TOL)
        for r in range(margins.shape[0]):
            print("margins " + json.dumps({
                "row": r, "positions": [545, 552],
                "rule": [round(float(x), 5) for x in margins[r, 545:553]],
                "threshold_aware": [round(float(x), 5) for x in near[r, 545:553]]}), flush=True)
        return margins

    cs.noised_margins = reporting_margins
    cs.DRAIN_AT = args.drain_at
    held, reason = True, ""
    try:
        cs.serve_migrated(torch, model, vae, specs, reference, f"witness DRAIN_AT {args.drain_at}")
    except RuntimeError as exc:
        held, reason = False, str(exc)
    print(smi)
    print(json.dumps({"tree": args.tree or "this", "drain_at": args.drain_at, "checks_held": held,
                      "failure": reason}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
