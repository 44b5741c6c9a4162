"""Train a CLIP reranker on the card (the port's twin of the repository's
`train_clip.py`).

    python -m dalle_pytorch_tpu_torch.train_clip --image_text_folder rainbow:64 \\
        [--output clip.npz] [--epochs 5] [--batch_size 64] [--learning_rate 3e-4] \\
        [--image_size 128] [--patch_size 16] [--text_seq_len 64] [--dim 256] \\
        [--dim_latent 256] [--depth 4] [--heads 8] [--bpe_path P] \\
        [--executor unrolled|scan] [--steps_per_dispatch 1] [--device cpu]

The flags are the reference CLI's, plus `--device` (the card unless
`--device cpu`). The dataset is the one `build_dataset` names (rainbow:N,
a folder, tar shards) with truncated captions; the CLIP's text vocabulary
is the tokenizer's. Each optimizer step is `make_clip_train_step` (the
symmetric contrastive loss, global-norm clipping at 1, Adam), in windows
of `--steps_per_dispatch` (an epoch tail runs step by step); the loss is
read back and logged when a step crosses a multiple of 10. `--output` is
written after every epoch (`save_clip_checkpoint`: the JAX
`load_clip_checkpoint` and `generate --clip_path` read it), in the
layout `--executor` names: the port trains the unrolled modules either
way, and "scan" writes the JAX scan executor's layout. Without wandb the
scalars go to `clip_logs/metrics.jsonl` beside `--output`.

`main(argv)` runs in-process and returns a summary of the run.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import torch

from dalle_pytorch_tpu_torch.data.prefetch import host_tensors, to_device
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.serving.engine import resolve_device
from dalle_pytorch_tpu_torch.training.config import TrainConfig, config_to_dict
from dalle_pytorch_tpu_torch.training.metrics import MetricsLogger, StepTimer, ThroughputMeter
from dalle_pytorch_tpu_torch.training.pipeline import (
    build_dataset,
    build_tokenizer,
    save_clip_checkpoint,
)
from dalle_pytorch_tpu_torch.training.steps import (
    make_clip_train_step,
    make_multi_step,
    make_optimizer,
    window_iter,
    window_keys,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_text_folder", type=str, required=True)
    p.add_argument("--output", type=str, default="clip.npz")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--text_seq_len", type=int, default=64)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--dim_latent", type=int, default=256)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument(
        "--executor", choices=("unrolled", "scan"), default="unrolled",
        help="parameter layout of the checkpoint (the JAX package's layer executor)",
    )
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="optimizer steps grouped into one window (make_multi_step)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = TrainConfig()
    cfg.image_text_folder = args.image_text_folder
    cfg.bpe_path = args.bpe_path
    cfg.truncate_captions = True
    cfg.model.text_seq_len = args.text_seq_len
    tokenizer = build_tokenizer(config_to_dict(cfg))
    data = build_dataset(cfg, tokenizer, args.image_size)
    print(f"{len(data)} text-image pairs for training")

    torch.manual_seed(0)
    with device:  # initialized where it trains
        clip = CLIP(
            dim_text=args.dim, dim_image=args.dim, dim_latent=args.dim_latent,
            num_text_tokens=max(tokenizer.vocab_size, 1), text_enc_depth=args.depth,
            text_seq_len=args.text_seq_len, text_heads=args.heads,
            visual_enc_depth=args.depth, visual_heads=args.heads,
            visual_image_size=args.image_size, visual_patch_size=args.patch_size,
            executor=args.executor,
        )
    print(f"{sum(p.numel() for p in clip.parameters()):,} parameters")
    opt = make_optimizer(clip.parameters(), args.learning_rate, clip_grad_norm=1.0)
    raw_step = make_clip_train_step(clip, opt)
    on_card = device.type == "cuda"
    timer = StepTimer(on_card)

    def keyed_step(host_batch, key: int):
        timer.start()
        metrics = raw_step(to_device(host_batch, device), torch.Generator().manual_seed(key))
        timer.stop()
        return metrics

    spd = max(1, args.steps_per_dispatch)
    run_steps = {n: make_multi_step(keyed_step, n) for n in {1, spd}}
    logger = MetricsLogger(project="clip_tpu", config=vars(args), debug=args.debug,
                           out_dir=str(Path(args.output).parent / "clip_logs"))
    meter = ThroughputMeter()
    summary = dict(losses=[])
    global_step = 0
    for epoch in range(args.epochs):
        for win in window_iter(data.batches(args.batch_size, shuffle_seed=epoch), spd):
            prev_step = global_step
            for part in ([win] if len(win) == spd else [[one] for one in win]):
                hosts = [host_tensors({k: b[k] for k in ("text", "images")}, on_card) for b in part]
                m = run_steps[len(part)](hosts, window_keys(1, global_step, len(part)))
                global_step += len(part)
            if global_step // 10 > prev_step // 10:
                loss = float(m["loss"])
                summary["losses"].append((global_step, loss))
                print(f"epoch {epoch} step {global_step}: loss {loss:.4f}")
                logger.log({"loss": loss, "epoch": epoch}, step=global_step)
                sps = meter.update(global_step, args.batch_size)
                if sps:
                    logger.log({"samples_per_sec": sps}, step=global_step)
        save_clip_checkpoint(args.output, clip)
        print(f"epoch {epoch} done; checkpoint -> {args.output}")
    if on_card:
        torch.cuda.synchronize()
    logger.finish()
    summary.update(global_step=global_step, out_file=args.output, step_ms=timer.step_ms(),
                   last_loss=float(m["loss"]) if global_step else None)
    return summary


if __name__ == "__main__":
    main()
