"""DALL-E text->image token transformer: the training forward and loss,
cached decode and batched sampling.

Counterpart of the JAX package's `models/dalle.py`: `DALLE.__call__` (the
logits or the split text/image cross-entropy, forward and inverse
objectives, the 3-token accuracy, the vocab-chunked `fused_ce` losses),
`embed_text` (unique padding ids, <bos> = 0, null conditioning),
`to_logits`, `decode_prefill`, `decode_image_step`, `init_decode_cache`
and `generate_images_cached_batched` with the classifier-free-guidance
blend. Random draws (null conditioning) come from an explicit
`torch.Generator`, so they are not jax.random's bits; dropout uses
torch's global generator.

The port holds its weights in the module (the reference keeps them in a
separate parameter tree; `weights.py` carries a tree across). A model's
floating dtype is its parameters' dtype (`model.to(torch.bfloat16)`);
logits come out in float32. Sampling runs as a Python loop over image
positions; the KV cache is updated in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.models.transformer import (
    LayerNorm,
    Transformer,
    make_decode_cache,
)
from dalle_pytorch_tpu_torch.ops.losses import chunked_masked_ce, split_weighted_mean
from dalle_pytorch_tpu_torch.ops.sampling import (
    gumbel_noise,
    gumbel_sample_per_row,
    top_k_filter_per_row,
)

NEG_MASK_VALUE = -float(np.finfo(np.float32).max)


class AxialPositionalEmbedding(nn.Module):
    """Row + column additive positional embedding over the image grid."""

    def __init__(self, dim: int, row: int, col: int):
        super().__init__()
        self.rows = nn.Parameter(torch.randn(row, 1, dim))
        self.cols = nn.Parameter(torch.randn(1, col, dim))

    def forward(self) -> torch.Tensor:
        return (self.rows + self.cols).reshape(-1, self.rows.shape[-1])


class DALLE(nn.Module):
    def __init__(
        self,
        dim: int,
        depth: int,
        num_image_tokens: int,
        image_fmap_size: int,
        num_text_tokens: int = 10000,
        text_seq_len: int = 256,
        heads: int = 8,
        dim_head: int = 64,
        attn_types: Optional[Sequence[str]] = None,
        stable: bool = False,
        sandwich_norm: bool = False,
        shift_tokens: bool = True,
        rotary_emb: bool = True,
        shared_attn_ids: Optional[Sequence[int]] = None,
        shared_ff_ids: Optional[Sequence[int]] = None,
        share_input_output_emb: bool = False,
        attn_impl: str = "auto",
        reversible: bool = False,
        reversible_impl: str = "remat",
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        loss_img_weight: float = 7.0,
        text_loss_coeff: float = 1.0,
        img_loss_coeff: Optional[float] = None,
        text_loss_coeff_inv: float = 7.0,
        img_loss_coeff_inv: float = 1.0,
        fused_ce: bool = False,
    ):
        """Arguments as the reference's fields. `img_loss_coeff` None takes
        `loss_img_weight`; `fused_ce` computes the loss without
        materializing [B, N, V] logits (`ops/losses.py`)."""
        super().__init__()
        self.dim, self.depth = dim, depth
        self.heads, self.dim_head = heads, dim_head
        self.num_text_tokens = num_text_tokens
        self.num_image_tokens = num_image_tokens
        self.image_fmap_size = image_fmap_size
        self.text_seq_len = text_seq_len
        self.stable = stable
        self.shift_tokens = shift_tokens
        self.rotary_emb = rotary_emb
        self.share_input_output_emb = share_input_output_emb
        self.attn_types = tuple(attn_types) if attn_types else ("full",)
        self.shared_attn_ids = None if shared_attn_ids is None else tuple(shared_attn_ids)
        self.shared_ff_ids = None if shared_ff_ids is None else tuple(shared_ff_ids)
        self.attn_impl = attn_impl
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        self.text_loss_coeff = text_loss_coeff
        self.img_loss_coeff = loss_img_weight if img_loss_coeff is None else img_loss_coeff
        self.text_loss_coeff_inv = text_loss_coeff_inv
        self.img_loss_coeff_inv = img_loss_coeff_inv
        self.fused_ce = fused_ce

        self.text_emb = nn.Embedding(self.total_text_tokens, dim)
        self.image_emb = nn.Embedding(num_image_tokens, dim)
        if not rotary_emb:
            self.text_pos_emb = nn.Embedding(text_seq_len + 1, dim)
            self.image_pos_emb = AxialPositionalEmbedding(dim, image_fmap_size, image_fmap_size)
        self.transformer = Transformer(
            dim=dim,
            depth=depth,
            seq_len=self.total_seq_len,
            heads=heads,
            dim_head=dim_head,
            attn_types=attn_types,
            image_fmap_size=image_fmap_size,
            stable=stable,
            sandwich_norm=sandwich_norm,
            shift_tokens=shift_tokens,
            rotary_emb=rotary_emb,
            shared_attn_ids=shared_attn_ids,
            shared_ff_ids=shared_ff_ids,
            attn_impl=attn_impl,
            attn_dropout=attn_dropout,
            ff_dropout=ff_dropout,
            reversible=reversible,
            reversible_impl=reversible_impl,
        )
        self.logits_norm = LayerNorm(dim)
        if share_input_output_emb:
            self.logits_bias = nn.Parameter(torch.zeros(self.total_tokens))
        else:
            self.logits_dense = nn.Linear(dim, self.total_tokens)

    @property
    def total_text_tokens(self) -> int:
        return self.num_text_tokens + self.text_seq_len

    @property
    def image_seq_len(self) -> int:
        return self.image_fmap_size**2

    @property
    def total_seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def total_tokens(self) -> int:
        return self.total_text_tokens + self.num_image_tokens

    @property
    def dtype(self) -> torch.dtype:
        return self.text_emb.weight.dtype

    def embed_text(
        self,
        text: torch.Tensor,
        null_cond_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        """Unique-pad remap + <bos>: (ids [B, T+1], embeddings [B, T+1, dim]).
        With `null_cond_prob` > 0 each row's text is blanked (all pad) with
        that probability, drawn from `generator`."""
        if text.shape[-1] != self.text_seq_len:
            raise ValueError(
                f"text length {text.shape[-1]} != text_seq_len {self.text_seq_len}"
            )
        text = text.long()
        if null_cond_prob > 0:
            draw = torch.rand((text.shape[0], 1), generator=generator, device=text.device)
            text = torch.where(draw < null_cond_prob, torch.zeros_like(text), text)
        text_range = torch.arange(self.text_seq_len, device=text.device) + (
            self.total_text_tokens - self.text_seq_len
        )
        text = torch.where(text == 0, text_range, text)
        text = F.pad(text, (1, 0))  # <bos> = 0
        tokens = self.text_emb(text)
        if not self.rotary_emb:
            tokens = tokens + self.text_pos_emb.weight[None]
        return text, tokens

    def _divide_max(self, out: torch.Tensor) -> torch.Tensor:
        return out / out.amax(dim=-1, keepdim=True).detach()

    def _logits_kernel(self):
        """(kernel [D, V], bias [V] or None) of the logits head."""
        if self.share_input_output_emb:
            kernel = torch.cat([self.text_emb.weight, self.image_emb.weight], dim=0).t()
            return kernel, self.logits_bias
        return self.logits_dense.weight.t(), self.logits_dense.bias

    def to_logits(self, out: torch.Tensor) -> torch.Tensor:
        if self.stable:
            out = self._divide_max(out)
        out = self.logits_norm(out)
        if self.share_input_output_emb:
            kernel, bias = self._logits_kernel()
            return out @ kernel.to(out.dtype) + bias.to(out.dtype)
        return self.logits_dense(out)

    def logits_blocked(self, seq_len: int, inverse: bool, device=None) -> torch.Tensor:
        """[seq_len, total_tokens] bool, True = blocked: text rows emit only
        text ids and image rows only image ids; `inverse` rotates the rows
        by text_seq_len (the image comes first)."""
        rows = torch.arange(seq_len, device=device)
        if inverse:
            rows = (rows + self.text_seq_len) % self.total_seq_len
        vocab = torch.arange(self.total_tokens, device=device)[None, :]
        return (rows < self.text_seq_len)[:, None] != (vocab < self.total_text_tokens)

    def forward(
        self,
        text: torch.Tensor,
        image: Optional[torch.Tensor] = None,
        return_loss: bool = False,
        inverse_mapping: bool = False,
        reverse_model: bool = False,
        null_cond_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        """text [B, text_seq_len] ids; image [B, <= image_seq_len] codebook
        ids. Returns masked float32 logits [B, N, V], or with `return_loss`
        (loss, accuracy): the split cross-entropy of the forward (text ->
        image) or, with `inverse_mapping`, the inverse (image first) objective
        and its 3-token accuracy (None for the forward one)."""
        text, tokens = self.embed_text(text, null_cond_prob, generator)
        if image is not None and image.shape[1] > 0:
            image_emb = self.image_emb(image.long())
            if not self.rotary_emb:
                image_emb = image_emb + self.image_pos_emb()[: image_emb.shape[1]]
            parts = [image_emb, tokens] if inverse_mapping else [tokens, image_emb]
            tokens = torch.cat(parts, dim=1)
        seq_len = min(tokens.shape[1], self.total_seq_len)
        tokens = tokens[:, :seq_len]  # drop the final token's input slot
        if self.stable:
            tokens = tokens * 0.1 + tokens.detach() * 0.9
        out = self.transformer(tokens, reverse_model=reverse_model)

        if return_loss and image is None:
            raise ValueError("when training, image must be supplied")
        if return_loss and self.fused_ce:
            loss_fn = self._fused_inverse_loss if inverse_mapping else self._fused_forward_loss
            return loss_fn(out, text, image.long(), seq_len)

        logits = self.to_logits(out).float()
        blocked = self.logits_blocked(seq_len, inverse_mapping, logits.device)
        logits = logits.masked_fill(blocked[None], NEG_MASK_VALUE)
        if not return_loss:
            return logits

        offsetted_image = image.long() + self.total_text_tokens
        if inverse_mapping:
            labels = torch.cat([offsetted_image[:, 1:], text], dim=1)
            split = self.image_seq_len
            loss_text = F.cross_entropy(logits[:, split:].flatten(0, 1), labels[:, split:].flatten())
            loss_img = F.cross_entropy(
                logits[:, : split - 1].flatten(0, 1), labels[:, : split - 1].flatten()
            )
            pred3 = logits[:, split : split + 3].argmax(dim=-1)
            accuracy = (pred3 == labels[:, split : split + 3]).all(dim=-1).float().mean()
            ct, ci = self.text_loss_coeff_inv, self.img_loss_coeff_inv
        else:
            labels = torch.cat([text[:, 1:], offsetted_image], dim=1)
            split = self.text_seq_len
            loss_text = F.cross_entropy(logits[:, :split].flatten(0, 1), labels[:, :split].flatten())
            loss_img = F.cross_entropy(logits[:, split:].flatten(0, 1), labels[:, split:].flatten())
            accuracy = None
            ct, ci = self.text_loss_coeff, self.img_loss_coeff
        return (ct * loss_text + ci * loss_img) / (ct + ci), accuracy

    def _fused_head(self, out: torch.Tensor):
        if self.stable:
            out = self._divide_max(out)
        kernel, bias = self._logits_kernel()
        return self.logits_norm(out), kernel, bias

    def _fused_forward_loss(self, out, text, image, seq_len):
        """Forward objective through the vocab-chunked CE; same numerics as
        the dense path."""
        h, kernel, bias = self._fused_head(out)
        labels = torch.cat([text[:, 1:], image + self.total_text_tokens], dim=1)
        row_is_text = torch.arange(seq_len, device=h.device) < self.text_seq_len
        per_pos = chunked_masked_ce(
            h, kernel, bias, labels, row_is_text=row_is_text,
            num_text_vocab=self.total_text_tokens,
        )
        loss = split_weighted_mean(
            per_pos, self.text_seq_len, self.text_loss_coeff, self.img_loss_coeff
        )
        return loss, None

    def _fused_inverse_loss(self, out, text, image, seq_len):
        """Inverse objective through the vocab-chunked CE, image segment
        without its final position; the 3-token accuracy from dense logits
        of those three text rows over the text vocabulary only."""
        h, kernel, bias = self._fused_head(out)
        labels = torch.cat([image[:, 1:] + self.total_text_tokens, text], dim=1)
        split = self.image_seq_len
        row_is_text = torch.arange(seq_len, device=h.device) >= split
        per_pos = chunked_masked_ce(
            h, kernel, bias, labels, row_is_text=row_is_text,
            num_text_vocab=self.total_text_tokens,
        )
        loss = split_weighted_mean(
            per_pos, split, self.img_loss_coeff_inv, self.text_loss_coeff_inv,
            drop_last_of_first=True,
        )
        h3 = h[:, split : split + 3]
        logits3 = torch.matmul(h3, kernel[:, : self.total_text_tokens].to(h3.dtype)).float()
        if bias is not None:
            logits3 = logits3 + bias[: self.total_text_tokens].float()
        pred3 = logits3.argmax(dim=-1)
        accuracy = (pred3 == labels[:, split : split + 3]).all(dim=-1).float().mean()
        return loss, accuracy

    def decode_prefill(self, text: torch.Tensor, cache: dict):
        """Run bos + text through the trunk, filling the cache from position
        0. Returns (logits for image position 0 [B, V] float32, cache)."""
        _, tokens = self.embed_text(text)
        out = self.transformer(tokens, cache)
        return self.to_logits(out[:, -1:])[:, 0].float(), cache

    def decode_image_step(self, img_token: torch.Tensor, image_pos: int, cache: dict):
        """Feed one image token at grid index `image_pos`; returns (logits
        for the next position [B, V] float32, cache)."""
        emb = self.image_emb(img_token[:, None].long())
        if not self.rotary_emb:
            p = min(max(int(image_pos), 0), self.image_seq_len - 1)
            emb = emb + self.image_pos_emb()[p][None, None]
        out = self.transformer(emb, cache)
        return self.to_logits(out)[:, 0].float(), cache


def init_decode_cache(model: DALLE, batch: int) -> dict:
    """Fixed-shape cache of total_seq_len + 1 positions, in the model's
    dtype and on its device (the final image token is fed too; its write
    lands in the spare slot)."""
    return make_decode_cache(
        depth=model.depth,
        batch=batch,
        max_len=model.total_seq_len + 1,
        heads=model.heads,
        dim_head=model.dim_head,
        dim=model.dim,
        image_fmap_size=model.image_fmap_size,
        shift_tokens=model.shift_tokens,
        dtype=model.dtype,
        device=model.text_emb.weight.device,
    )


@torch.inference_mode()
def generate_images_cached_batched(
    model: DALLE,
    text: torch.Tensor,
    seeds: Sequence[int],
    temperatures: torch.Tensor,
    keep_k: torch.Tensor,
    cond_scale: float = 1.0,
    vae=None,
):
    """KV-cached sampling with per-row seed / temperature / keep count.

    text [B, text_seq_len] ids; seeds: B host ints; temperatures [B];
    keep_k [B] logits kept per row. Row i's noise at image position p is
    keyed by (seeds[i], p) alone, so a request samples the same tokens in
    any batch. Returns image tokens [B, image_seq_len] int64, or (tokens,
    pixels [B, H, W, C]) when a `DiscreteVAE` is given.
    """
    b = text.shape[0]
    device = text.device
    use_null = cond_scale != 1.0
    if use_null:  # null conditioning == all-pad text, stacked on batch
        text = torch.cat([text, torch.zeros_like(text)], dim=0)
    cache = init_decode_cache(model, text.shape[0])
    row, cache = model.decode_prefill(text, cache)

    blocked = (torch.arange(model.total_tokens, device=device) < model.total_text_tokens)[None]
    k_max = int(keep_k.max())  # before the copy to the device: no sync
    keep_k = keep_k.to(device)
    temperatures = temperatures.to(device)
    seeds = [int(s) for s in seeds]
    img_tokens = torch.zeros((b, model.image_seq_len), dtype=torch.long, device=device)
    for i in range(model.image_seq_len):
        if use_null:
            row = row[b:] + (row[:b] - row[b:]) * cond_scale
        masked = row.masked_fill(blocked, NEG_MASK_VALUE)
        filtered = top_k_filter_per_row(masked, keep_k, k_max=k_max)
        noise = gumbel_noise(seeds, i, model.total_tokens, device)
        sample = gumbel_sample_per_row(filtered, temperatures, noise) - model.total_text_tokens
        img_tokens[:, i] = sample
        feed = torch.cat([sample, sample]) if use_null else sample
        row, cache = model.decode_image_step(feed, i, cache)
    if vae is None:
        return img_tokens
    return img_tokens, vae.decode(img_tokens)
