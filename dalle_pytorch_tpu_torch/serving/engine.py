"""GenerationEngine: batched text->image generation over fixed batch shapes.

Counterpart of the JAX package's micro `serving/engine.py:GenerationEngine`
and `engine_from_checkpoint`. The engine keeps a ladder of batch shapes,
pads every micro-batch up to the nearest rung with copies of row 0 and
slices the padding back off; per-row seed / temperature / top-k ride as
tensors, and a row's sampling noise depends on (seed, image position)
only, so a request gets the same tokens whichever batch it lands in. The
dVAE decode is fused: `generate` returns tokens and pixels in [0, 1].

PyTorch runs eagerly, so there is nothing to compile per shape; `warmup`
runs one dummy batch per rung so the first request pays no one-time cost
(kernel build, library handles, allocator growth). Vitals, cost tables,
the compile cache, fault injection and CLIP rerank are not ported yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE, generate_images_cached_batched
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.training.pipeline import (
    dalle_from_config,
    dvae_from_hparams,
    load_dalle_checkpoint,
)
from dalle_pytorch_tpu_torch.weights import load_dalle_params, load_dvae_params


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, raising when CUDA is asked for but absent:
    entry points default to the card, and a run without one must say so
    instead of quietly running the plain CPU versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False: the port runs on an NVIDIA GPU; pass device='cpu' to "
            "run its plain PyTorch versions on the CPU"
        )
    return dev


@dataclass
class SampleSpec:
    """One batch row: a tokenized prompt plus its sampling parameters.
    `top_k` is the FRACTION of the vocabulary to drop (0.9 keeps 10%)."""

    text_ids: np.ndarray  # [text_seq_len] int32
    seed: int = 0
    temperature: float = 1.0
    top_k: float = 0.9


@dataclass
class EngineStats:
    batches: int = 0
    rows_generated: int = 0
    rows_padded: int = 0
    warmup_batches: int = 0  # warmup runs count here only


class GenerationEngine:
    """Batched generation over a fixed ladder of batch shapes.

    model: a `DALLE` with its weights; vae: an optional `DiscreteVAE`
    (pixels are decoded in the same call); device: "cuda" unless the
    caller asks for the CPU. The modules are moved to `device`.
    """

    def __init__(
        self,
        model: DALLE,
        vae: Optional[DiscreteVAE] = None,
        batch_shapes: Sequence[int] = (1, 4, 8),
        cond_scale: float = 1.0,
        tokenizer=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if not batch_shapes or min(int(b) for b in batch_shapes) < 1:
            raise ValueError(f"batch_shapes must be positive sizes, got {batch_shapes}")
        self.model = model.to(self.device).eval()
        self.vae = None if vae is None else vae.to(self.device).eval()
        self.batch_shapes = tuple(sorted(set(int(b) for b in batch_shapes)))
        self.max_batch = self.batch_shapes[-1]
        self.cond_scale = float(cond_scale)
        self.tokenizer = tokenizer
        self._lock = threading.Lock()  # one generation on the device at a time
        self.stats = EngineStats()

    def pick_shape(self, n: int) -> int:
        """Smallest rung that fits n rows."""
        if not 1 <= n <= self.max_batch:
            raise ValueError(
                f"batch of {n} rows outside [1, {self.max_batch}] (the engine's "
                "largest shape)"
            )
        return next(b for b in self.batch_shapes if n <= b)

    @property
    def image_seq_len(self) -> int:
        return self.model.image_seq_len

    def _keep_k(self, top_k: float) -> int:
        """Fractional drop threshold -> per-row keep count."""
        v = self.model.total_tokens
        frac = min(max(float(top_k), 0.0), 1.0)
        return max(int((1.0 - frac) * v), 1)

    def tokenize(self, prompt: str) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError(
                "engine built without a tokenizer (the port has the byte "
                "tokenizer only; BPE tokenizers are not ported yet)"
            )
        ids = self.tokenizer.tokenize(prompt, self.model.text_seq_len, truncate_text=True)
        return np.asarray(ids[0], dtype=np.int32)

    def warmup(self) -> None:
        """Run one dummy batch per rung (counted in stats.warmup_batches)."""
        text_seq = self.model.text_seq_len
        for b in self.batch_shapes:
            dummy = [SampleSpec(np.zeros(text_seq, np.int32), seed=i) for i in range(b)]
            self.generate(dummy, _warmup=True)

    def generate(self, specs: Sequence[SampleSpec], _warmup: bool = False):
        """Run one micro-batch. Returns (tokens [n, image_seq_len] np.int32,
        pixels [n, H, W, 3] float32 in [0, 1] or None)."""
        n = len(specs)
        shape = self.pick_shape(n)
        pad = shape - n
        rows = list(specs) + [specs[0]] * pad
        text = np.stack([np.asarray(s.text_ids, np.int32) for s in rows])
        if text.shape != (shape, self.model.text_seq_len):
            raise ValueError(
                f"prompt rows must be [{self.model.text_seq_len}] token ids, "
                f"got batch {text.shape}"
            )
        seeds = [int(s.seed) & 0x7FFFFFFF for s in rows]
        temps = torch.tensor([float(s.temperature) for s in rows], dtype=torch.float32)
        keep = torch.tensor([self._keep_k(s.top_k) for s in rows], dtype=torch.int32)

        with self._lock:
            out = generate_images_cached_batched(
                self.model,
                torch.from_numpy(text).to(self.device),
                seeds, temps, keep,
                cond_scale=self.cond_scale,
                vae=self.vae,
            )
            if self.vae is None:
                toks, pixels = out, None
            else:
                toks, pixels = out
                pixels = (pixels[:n].float() * 0.5 + 0.5).clamp(0.0, 1.0).cpu().numpy()
            toks = toks[:n].to(torch.int32).cpu().numpy()
            if _warmup:
                self.stats.warmup_batches += 1
            else:
                self.stats.batches += 1
                self.stats.rows_generated += n
                self.stats.rows_padded += pad
        return toks, pixels


def engine_from_checkpoint(
    dalle_path: str,
    batch_shapes: Sequence[int] = (1, 4, 8),
    cond_scale: float = 1.0,
    device="cuda",
) -> GenerationEngine:
    """Build a `GenerationEngine` from a reference single-file DALLE
    checkpoint (with its DiscreteVAE inside), in the checkpoint's dtype
    (bfloat16 when it was trained with bf16).

    The text vocabulary size comes from the checkpoint's text embedding.
    When it is the byte tokenizer's, the engine gets a `ByteTokenizer`;
    otherwise it has none (the BPE tokenizers are not ported) and takes
    token ids only.
    """
    dev = resolve_device(device)
    config, dalle_tree, vae_tree, meta = load_dalle_checkpoint(dalle_path)
    if meta.get("vae_class_name") != "DiscreteVAE" or vae_tree is None:
        raise NotImplementedError(
            f"checkpoint VAE {meta.get('vae_class_name')!r}: only a DiscreteVAE "
            "stored in the checkpoint is ported; the pretrained VAE wrappers "
            "are not"
        )
    vae = load_dvae_params(dvae_from_hparams(meta["vae_hparams"]), vae_tree)
    text_rows = dalle_tree["text_emb"]["embedding"].shape[0]
    vocab = text_rows - config["model"]["text_seq_len"]
    model, dtype = dalle_from_config(
        config,
        num_image_tokens=vae.num_tokens,
        image_fmap_size=vae.fmap_size,
        vocab_size=vocab,
    )
    load_dalle_params(model, dalle_tree)
    tokenizer = ByteTokenizer() if vocab == ByteTokenizer().vocab_size else None
    return GenerationEngine(
        model.to(dtype),
        vae.to(dtype),
        batch_shapes=batch_shapes,
        cond_scale=cond_scale,
        tokenizer=tokenizer,
        device=dev,
    )
