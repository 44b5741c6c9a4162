"""Precompute frozen-dVAE image tokens for a dataset, on the card (the
port's twin of the repository's `precompute_tokens.py`).

    python -m dalle_pytorch_tpu_torch.precompute_tokens --image_text_folder data/ \\
        --vae_path vae.npz --output tokens.npz [--batch_size 64] [--device cpu]
    python -m dalle_pytorch_tpu_torch.train_dalle --tokens_path tokens.npz --vae_path vae.npz ...

Encodes every sample of the dataset once (`DiscreteVAE.
get_codebook_indices`, float32) and writes the artifact the reference
writes: the raw captions (tokenized at train time by whatever tokenizer
the run picks), int32 image tokens [N, (image_size / 2^num_layers)^2] and
the VAE's geometry (`num_tokens`, `image_size`, `num_layers`,
`vae_class_name`), so a `--tokens_path` run of either package reads it.
The flags are the reference's, plus `--device`; `--taming` (the VQGAN) is
not ported (ROADMAP Queue 1 item 7). `main(argv)` runs in-process and
returns the token array.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_text_folder", type=str, required=True)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--taming", action="store_true")
    p.add_argument("--vqgan_model_path", type=str, default=None)
    p.add_argument("--vqgan_config_path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--output", type=str, default="tokens.npz")
    # the tokenizer flags only reach the dataset's tokenize pass, whose ids
    # are not stored (the captions are); a folder that tokenizes eagerly
    # then never fails on a long caption with another vocabulary
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--native", action="store_true")
    p.add_argument("--hug", action="store_true")
    p.add_argument("--chinese", action="store_true")
    p.add_argument("--yttm", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    from dalle_pytorch_tpu_torch.serving.engine import resolve_device
    from dalle_pytorch_tpu_torch.training.config import TrainConfig, config_to_dict
    from dalle_pytorch_tpu_torch.training.pipeline import (
        build_dataset,
        build_tokenizer,
        build_vae,
    )
    from dalle_pytorch_tpu_torch.training.steps import encode_images

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = TrainConfig()
    cfg.vae_path, cfg.taming = args.vae_path, args.taming
    if not args.vae_path and not args.taming:
        raise ValueError("--vae_path or --taming required")
    vae = build_vae(cfg).to(device).eval()  # --taming raises: not ported

    cfg.image_text_folder = args.image_text_folder
    cfg.truncate_captions = True
    for flag in ("bpe_path", "native", "hug", "chinese", "yttm"):
        if getattr(args, flag):
            setattr(cfg, flag, getattr(args, flag))
    tokenizer = build_tokenizer(config_to_dict(cfg))
    dataset = build_dataset(cfg, tokenizer, image_size=vae.image_size)
    print(f"encoding {len(dataset)} samples at {vae.image_size}px")

    captions, token_chunks = [], []
    n_done = 0
    for batch in dataset.batches(args.batch_size, shuffle_seed=None, drop_last=False):
        images = torch.from_numpy(np.ascontiguousarray(batch["images"])).to(device)
        toks = encode_images(vae, images).cpu().numpy().astype(np.int32)
        token_chunks.append(toks)
        captions.extend(batch["captions"])
        n_done += toks.shape[0]
        if n_done % (args.batch_size * 10) < args.batch_size:
            print(f"  {n_done} done")

    image_tokens = np.concatenate(token_chunks, axis=0)
    np.savez_compressed(
        args.output,
        captions=np.array(captions),
        image_tokens=image_tokens,
        num_tokens=vae.num_tokens,
        image_size=vae.image_size,
        num_layers=vae.num_layers,
        vae_class_name="DiscreteVAE",
    )
    print(f"wrote {image_tokens.shape[0]} x {image_tokens.shape[1]} tokens -> {args.output}")
    return image_tokens


if __name__ == "__main__":
    main()
