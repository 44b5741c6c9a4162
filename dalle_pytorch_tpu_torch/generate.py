"""Generate images from a trained DALL-E checkpoint, on the card (the port's
twin of the repository's `generate.py`).

    python -m dalle_pytorch_tpu_torch.generate --dalle_path dalle.npz \\
        --text "a red cube|a blue sphere" --num_images 4 --batch_size 4 \\
        [--clip_path clip.npz] [--gentxt] [--no_cache] [--device cpu]

Loads the single-file checkpoint (DALLE, its DiscreteVAE, the config)
through `engine_from_checkpoint`, whose tokenizer is the one the config
names; splits the prompts on '|'; with `--gentxt` completes each prompt's
text first (`generate_texts`); samples `--num_images` per prompt in
batches of `--batch_size` through the micro `GenerationEngine` (KV-cached
decode, per-row seeds spread from `--seed`, the dVAE decode fused), or
with `--no_cache` through the uncached `generate_images` oracle, bypassing
the engine; with `--clip_path` reranks each prompt's images best-first by
CLIP similarity; and writes `{i}.png` and `grid.png` per prompt into
`--outputs_dir/<sanitised prompt>/` (PNG written with zlib, no imaging
package). Runs on the card unless `--device cpu`.

`main(argv)` runs it in-process and returns a summary (per prompt: the
output directory, the completed text, its token ids, the image tokens in
sampling order, the CLIP scores best first and their order; the wall of
each stage).
"""

from __future__ import annotations

import argparse
import itertools
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models.dalle import generate_images, generate_texts
from dalle_pytorch_tpu_torch.ops.sampling import row_seed
from dalle_pytorch_tpu_torch.serving.engine import SampleSpec, engine_from_checkpoint
from dalle_pytorch_tpu_torch.utils.images import save_image_grid, to_uint8, write_png


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dalle_path", type=str, required=True)
    p.add_argument("--text", type=str, required=True, help="'|'-separated prompts")
    p.add_argument("--num_images", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--top_k", type=float, default=0.9)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--cond_scale", type=float, default=1.0)
    p.add_argument("--outputs_dir", type=str, default="outputs")
    p.add_argument(
        "--clip_path", type=str, default=None,
        help="CLIP checkpoint; generations are reranked by similarity and saved best-first",
    )
    p.add_argument("--gentxt", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--no_cache", action="store_true",
        help="use the full-reforward sampling oracle instead of KV-cached decode",
    )
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    walls = dict.fromkeys(("load", "tokenize", "generate", "rerank", "write"), 0.0)
    t0 = time.perf_counter()
    # one batch shape: the CLI always dispatches full --batch_size batches
    # (the engine pads the final partial one)
    engine = engine_from_checkpoint(
        args.dalle_path, clip_path=args.clip_path, batch_shapes=(args.batch_size,),
        cond_scale=args.cond_scale, device=args.device,
    )
    model, tokenizer, device = engine.model, engine.tokenizer, engine.device
    walls["load"] = time.perf_counter() - t0
    # the seed stream of --gentxt and --no_cache (one draw each), and the
    # engine rows' seeds spread so --seed N and N + 1 share no image
    draws = itertools.count()
    next_seed = (args.seed * 1_000_003) & 0x7FFFFFFF
    summary = {"prompts": [], "walls": walls}

    for raw_prompt in args.text.split("|"):
        prompt = raw_prompt.strip()
        completed = None
        if args.gentxt:
            t0 = time.perf_counter()
            ids = tokenizer.tokenize(prompt, model.text_seq_len, truncate_text=True)
            prefix_len = int((ids[0] != 0).sum())
            text = generate_texts(
                model, torch.tensor(ids, device=device), prefix_len,
                seed=row_seed(args.seed, next(draws)),
            )
            pad = set(range(model.total_text_tokens - model.text_seq_len, model.total_text_tokens))
            prompt = completed = tokenizer.decode(text[0].cpu().numpy(), pad_tokens=pad)
            print(f"completed text: {prompt!r}")
            walls["generate"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        text_ids = engine.tokenize(prompt)
        walls["tokenize"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        images, tokens = [], []
        for start in range(0, args.num_images, args.batch_size):
            n = min(args.batch_size, args.num_images - start)
            if args.no_cache:
                # the full-reforward oracle, bypassing the engine on purpose
                chunk = torch.tensor(np.repeat(text_ids[None], n, axis=0), device=device)
                toks = generate_images(
                    model, chunk, seed=row_seed(args.seed, next(draws)),
                    filter_thres=args.top_k, temperature=args.temperature,
                    cond_scale=args.cond_scale,
                )
                with torch.inference_mode():
                    pixels = engine.vae.decode(toks)
                images.append(pixels.float().cpu().numpy() * 0.5 + 0.5)  # un-normalize
                tokens.append(toks.to(torch.int32).cpu().numpy())
                continue
            specs = [
                SampleSpec(text_ids=text_ids, seed=next_seed + i, temperature=args.temperature,
                           top_k=args.top_k)
                for i in range(n)
            ]
            next_seed += n
            toks, pixels = engine.generate(specs)
            if pixels is None:
                raise RuntimeError("checkpoint has no VAE to decode pixels")
            images.append(pixels)
            tokens.append(toks)
        images = np.concatenate(images, axis=0)  # on the host: the device work is done
        walls["generate"] += time.perf_counter() - t0

        scores = order = None
        if engine.clip is not None:
            t0 = time.perf_counter()
            images, scores, order = engine.rerank(prompt, images)
            walls["rerank"] += time.perf_counter() - t0
            print("clip scores (best first):", np.asarray(scores)[:8])

        t0 = time.perf_counter()
        safe = "".join(c if c.isalnum() or c in " -." else "" for c in prompt)
        out_dir = Path(args.outputs_dir) / (safe.strip().replace(" ", "_")[:100] or "prompt")
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(images):
            write_png(out_dir / f"{i}.png", to_uint8(img))
        save_image_grid(images, out_dir / "grid.png")
        walls["write"] += time.perf_counter() - t0
        print(f"created {len(images)} images at {out_dir}")
        summary["prompts"].append(dict(
            prompt=prompt, completed=completed, out_dir=str(out_dir), text_ids=text_ids,
            tokens=np.concatenate(tokens, axis=0),
            scores=None if scores is None else [float(x) for x in scores],
            order=None if order is None else [int(x) for x in order],
        ))
    return summary


if __name__ == "__main__":
    main()
