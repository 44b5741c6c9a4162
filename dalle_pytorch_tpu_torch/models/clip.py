"""CLIP: text and image encoders with a symmetric InfoNCE objective, and
the reranking of generated images by CLIP similarity.

Counterpart of the JAX package's `models/clip.py` (`CLIP`, `clip_scores`,
`rerank`): token and patch embeddings plus learned positional embeddings,
bidirectional transformer encoders (`causal=False`, no rotary), masked
mean pooling of the text, L2-normalized latents, a learnable temperature
kept in log space, and the symmetric cross-entropy over the in-batch
similarity matrix. Images are [B, H, W, C] in [0, 1], as the reference's.
The encoders' attention follows the reference's choice ("auto"): a text
mask runs dense, and without one the non-causal flash-attention arm runs
from AUTO_FLASH_MIN_SEQ tokens on (`models/attention.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.models.transformer import Transformer


class CLIP(nn.Module):
    def __init__(
        self,
        dim_text: int = 512,
        dim_image: int = 512,
        dim_latent: int = 512,
        num_text_tokens: int = 10000,
        text_enc_depth: int = 6,
        text_seq_len: int = 256,
        text_heads: int = 8,
        num_visual_tokens: int = 512,
        visual_enc_depth: int = 6,
        visual_heads: int = 8,
        visual_image_size: int = 256,
        visual_patch_size: int = 32,
        channels: int = 3,
        executor: str = "unrolled",
    ):
        """Arguments as the reference's fields (`num_visual_tokens` is kept
        for the checkpoint's hparams; the image encoder reads pixels).
        `executor` ("unrolled" or "scan") is the parameter layout of the
        checkpoints the CLIP is written to: the modules are the unrolled
        executor's either way."""
        super().__init__()
        if executor not in ("unrolled", "scan"):
            raise ValueError(f"unknown executor {executor!r}; valid: unrolled, scan")
        self.executor = executor
        if visual_image_size % visual_patch_size:
            raise ValueError(
                f"visual_image_size {visual_image_size} must be a multiple of "
                f"visual_patch_size {visual_patch_size}"
            )
        self.dim_text, self.dim_image, self.dim_latent = dim_text, dim_image, dim_latent
        self.num_text_tokens, self.text_seq_len = num_text_tokens, text_seq_len
        self.text_enc_depth, self.text_heads = text_enc_depth, text_heads
        self.num_visual_tokens = num_visual_tokens
        self.visual_enc_depth, self.visual_heads = visual_enc_depth, visual_heads
        self.visual_image_size, self.visual_patch_size = visual_image_size, visual_patch_size
        self.channels = channels
        self.num_patches = (visual_image_size // visual_patch_size) ** 2

        self.text_emb = nn.Embedding(num_text_tokens, dim_text)
        self.text_pos_emb = nn.Embedding(text_seq_len, dim_text)
        self.text_transformer = Transformer(
            dim=dim_text, depth=text_enc_depth, seq_len=text_seq_len, heads=text_heads,
            rotary_emb=False, causal=False,
        )
        self.to_text_latent = nn.Linear(dim_text, dim_latent, bias=False)
        self.to_visual_embedding = nn.Linear(visual_patch_size**2 * channels, dim_image)
        self.visual_pos_emb = nn.Embedding(self.num_patches, dim_image)
        self.visual_transformer = Transformer(
            dim=dim_image, depth=visual_enc_depth, seq_len=self.num_patches,
            heads=visual_heads, rotary_emb=False, causal=False,
        )
        self.to_visual_latent = nn.Linear(dim_image, dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.ones(()))

    def _patches(self, image: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, n_patches, p * p * C], row-major patches."""
        p = self.visual_patch_size
        b, hh, ww, c = image.shape
        x = image.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (hh // p) * (ww // p), p * p * c)

    def forward(
        self,
        text: torch.Tensor,
        image: torch.Tensor,
        text_mask: Optional[torch.Tensor] = None,
        return_loss: bool = False,
    ) -> torch.Tensor:
        """text [B, T] ids, image [B, H, W, C], text_mask [B, T] (True =
        token). Returns the per-pair similarity [B] (times the temperature),
        or with `return_loss` the symmetric contrastive loss over the
        batch."""
        b = text.shape[0]
        positions = torch.arange(text.shape[1], device=text.device)
        text_emb = self.text_emb(text.long()) + self.text_pos_emb(positions)
        pixels = image.to(self.to_visual_embedding.weight.dtype)
        image_emb = self.to_visual_embedding(self._patches(pixels))
        image_emb = image_emb + self.visual_pos_emb.weight[None, : image_emb.shape[1]]

        enc_text = self.text_transformer(text_emb, key_mask=text_mask)
        enc_image = self.visual_transformer(image_emb)
        if text_mask is not None:
            m = text_mask[..., None].to(enc_text.dtype)
            text_latents = (enc_text * m).sum(1) / m.sum(1)
        else:
            text_latents = enc_text.mean(dim=1)
        image_latents = enc_image.mean(dim=1)

        text_latents = F.normalize(self.to_text_latent(text_latents), dim=-1, eps=0.0)
        image_latents = F.normalize(self.to_visual_latent(image_latents), dim=-1, eps=0.0)
        temp = self.temperature.exp()
        if not return_loss:
            return (text_latents * image_latents).sum(-1) * temp
        sim = text_latents @ image_latents.t() * temp
        labels = torch.arange(b, device=sim.device)
        return (F.cross_entropy(sim.float(), labels) + F.cross_entropy(sim.t().float(), labels)) / 2


@torch.inference_mode()
def clip_scores(
    clip: CLIP,
    text: torch.Tensor,
    images: torch.Tensor,
    text_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pair CLIP similarity of (text[i], images[i]) [B]."""
    return clip(text, images, text_mask=text_mask)


def rerank(
    clip: CLIP,
    text: torch.Tensor,
    images: torch.Tensor,
    text_mask: Optional[torch.Tensor] = None,
):
    """Sort generated images (and their scores) by descending CLIP
    similarity. A single prompt row is broadcast over the images. Returns
    (sorted images, sorted scores, order)."""
    if text.shape[0] == 1 and images.shape[0] > 1:
        text = text.expand(images.shape[0], -1)
        if text_mask is not None:
            text_mask = text_mask.expand(images.shape[0], -1)
    scores = clip_scores(clip, text, images, text_mask)
    order = torch.argsort(-scores, stable=True)
    return images[order], scores[order], order
