"""DALL-E text->image token transformer: the training forward and loss,
cached decode and batched sampling.

Counterpart of the JAX package's `models/dalle.py`: `DALLE.__call__` (the
logits or the split text/image cross-entropy, forward and inverse
objectives, the 3-token accuracy, the vocab-chunked `fused_ce` losses),
`embed_text` (unique padding ids, <bos> = 0, null conditioning),
`to_logits`, `decode_prefill`, `decode_image_step`, `init_decode_cache`,
`generate_images_cached_batched` with the classifier-free-guidance blend,
the generation CLI's samplers (`forward_with_cond_scale`, the uncached
`generate_images` oracle, `generate_images_cached` with priming,
`generate_texts`),
the continuous engine's slot ops (`init_slot_state`,
`prefill_into_slots`, `release_slots`, `decode_image_chunk`) and their
paged counterparts (`init_paged_slot_state`, `prefill_into_slots_paged`,
`slice_prefix_sidecar`, `admit_cached_prefix`,
`decode_image_chunk_paged`). Random
draws (null conditioning) come from an explicit `torch.Generator`, so
they are not jax.random's bits; dropout uses torch's global generator.

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

from dalle_pytorch_tpu_torch.models.attention import DECODE_SPARSE_BLOCK
from dalle_pytorch_tpu_torch.models.transformer import (
    LayerNorm,
    Transformer,
    make_decode_cache,
    make_paged_decode_cache,
    set_decode_cache_index,
)
from dalle_pytorch_tpu_torch.ops.losses import chunked_masked_ce, split_weighted_mean
from dalle_pytorch_tpu_torch.ops.sampling import (
    gumbel_noise,
    gumbel_sample_per_row,
    keep_count,
    row_seed,
    top_k_filter,
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
        kv_dtype: Optional[str] = None,
        decode_sparse_block: Optional[int] = None,
    ):
        """Arguments as the reference's fields. `img_loss_coeff` None takes
        `loss_img_weight`; `fused_ce` computes the loss without
        materializing [B, N, V] logits (`ops/losses.py`). `kv_dtype="int8"`
        gives decode caches an int8 K/V store; `decode_sparse_block` is the
        KV block width of decode-sparsity bitmaps (None: the attention
        module's DECODE_SPARSE_BLOCK)."""
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
        self.kv_dtype = kv_dtype
        self.decode_sparse_block = decode_sparse_block

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
        text, out = self.trunk(
            text, image, inverse_mapping, reverse_model, null_cond_prob, generator
        )
        seq_len = out.shape[1]
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

    def trunk(
        self,
        text: torch.Tensor,
        image: Optional[torch.Tensor] = None,
        inverse_mapping: bool = False,
        reverse_model: bool = False,
        null_cond_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        """The uncached trunk of `forward`: (text ids with <bos> [B, T + 1],
        the final hidden states [B, N, dim]), N = min(tokens, total_seq_len)."""
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
        return text, self.transformer(tokens, reverse_model=reverse_model)

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

    def decode_image_step(self, img_token: torch.Tensor, image_pos, cache: dict):
        """Feed one image token at grid index `image_pos` (a Python int, or
        a [B] tensor of per-row positions with a per-row cache); returns
        (logits for the next position [B, V] float32, cache)."""
        emb = self.image_emb(img_token[:, None].long())
        if not self.rotary_emb:
            table = self.image_pos_emb()
            if torch.is_tensor(image_pos):
                rows = image_pos.to(torch.long).clamp(0, self.image_seq_len - 1)
                emb = emb + table[rows][:, None]
            else:
                p = min(max(int(image_pos), 0), self.image_seq_len - 1)
                emb = emb + table[p][None, None]
        out = self.transformer(emb, cache)
        return self.to_logits(out)[:, 0].float(), cache


def init_decode_cache(model: DALLE, batch: int, per_row: bool = False) -> dict:
    """Fixed-shape cache of total_seq_len + 1 positions, in the model's
    dtype (K/V in `model.kv_dtype` when set) and on its device (the final
    image token is fed too; its write lands in the spare slot)."""
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
        per_row=per_row,
        kv_dtype=model.kv_dtype,
    )


def _primed_image_tokens(
    model: DALLE, batch: int, init_image_tokens, num_init_img_tokens: Optional[int], device
):
    """(image-token buffer [B, image_seq_len] with the priming prefix
    written in, primed length): the first `num_init_img_tokens` of
    `init_image_tokens` (default 43.75% of the grid, the reference's)."""
    img_tokens = torch.zeros((batch, model.image_seq_len), dtype=torch.long, device=device)
    primed = 0
    if init_image_tokens is not None:
        primed = (
            int(0.4375 * model.image_seq_len) if num_init_img_tokens is None
            else int(num_init_img_tokens)
        )
        if not 0 <= primed < model.image_seq_len:
            raise ValueError(f"primed length {primed} outside [0, {model.image_seq_len})")
        init = torch.as_tensor(np.asarray(init_image_tokens)[:, :primed], device=device)
        img_tokens[:, :primed] = init.long()
    return img_tokens, primed


def _batch_seeds(seed, batch: int) -> list:
    """Per-row noise seeds: `row_seed(seed, r)` for one int, or a sequence
    of `batch` per-row seeds as the engines take them."""
    if isinstance(seed, (int, np.integer)):
        return [row_seed(int(seed), r) for r in range(batch)]
    seeds = [int(s) & 0x7FFFFFFF for s in seed]
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} seeds for a batch of {batch}")
    return seeds


@torch.inference_mode()
def generate_images_cached_batched(
    model: DALLE,
    text: torch.Tensor,
    seeds: Sequence[int],
    temperatures: torch.Tensor,
    keep_k: torch.Tensor,
    cond_scale: float = 1.0,
    vae=None,
    init_image_tokens=None,
    num_init_img_tokens: Optional[int] = None,
):
    """KV-cached sampling with per-row seed / temperature / keep count.

    text [B, text_seq_len] ids; seeds: B host ints; temperatures [B];
    keep_k [B] logits kept per row. Row i's noise at image position p is
    keyed by (seeds[i], p) alone, so a request samples the same tokens in
    any batch. `init_image_tokens` [B, >= primed] primes the first
    `num_init_img_tokens` positions (default 43.75%): they are fed, not
    sampled. Returns image tokens [B, image_seq_len] int64, or (tokens,
    pixels [B, H, W, C]) when a `DiscreteVAE` is given.
    """
    b = text.shape[0]
    device = text.device
    use_null = cond_scale != 1.0
    img_tokens, primed = _primed_image_tokens(model, b, init_image_tokens, num_init_img_tokens, device)
    if use_null:  # null conditioning == all-pad text, stacked on batch
        text = torch.cat([text, torch.zeros_like(text)], dim=0)
    cache = init_decode_cache(model, text.shape[0])
    row, cache = model.decode_prefill(text, cache)

    blocked = (torch.arange(model.total_tokens, device=device) < model.total_text_tokens)[None]
    k_max = int(keep_k.max())  # before the copy to the device: no sync
    keep_k = keep_k.to(device)
    temperatures = temperatures.to(device)
    seeds = [int(s) for s in seeds]
    for i in range(model.image_seq_len):
        if i < primed:
            sample = img_tokens[:, i]
        else:
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


def generate_images_cached(
    model: DALLE,
    text: torch.Tensor,
    seed,
    filter_thres: float = 0.5,
    temperature: float = 1.0,
    cond_scale: float = 1.0,
    init_image_tokens=None,
    num_init_img_tokens: Optional[int] = None,
    vae=None,
):
    """KV-cached sampling with one `filter_thres` (fraction of the
    vocabulary dropped) and `temperature` for the batch, the reference's
    `generate_images_cached`: `seed` an int (row r's noise seed
    `row_seed(seed, r)`) or B per-row seeds; priming and `vae` as
    `generate_images_cached_batched`."""
    b = text.shape[0]
    keep = torch.full((b,), keep_count(filter_thres, model.total_tokens), dtype=torch.int32)
    temps = torch.full((b,), float(temperature), dtype=torch.float32)
    return generate_images_cached_batched(
        model, text, _batch_seeds(seed, b), temps, keep, cond_scale, vae,
        init_image_tokens, num_init_img_tokens,
    )


def forward_with_cond_scale(
    model: DALLE, text: torch.Tensor, image: Optional[torch.Tensor], cond_scale: float = 1.0
) -> torch.Tensor:
    """The classifier-free-guidance blend of two forwards: null + (logits -
    null) * cond_scale, null conditioning being the all-pad text."""
    logits = model(text, image)
    if cond_scale == 1:
        return logits
    null = model(text, image, null_cond_prob=1.0)
    return null + (logits - null) * cond_scale


def _logits_at(model: DALLE, text, image, pos: int, blocked, cond_scale: float) -> torch.Tensor:
    """The masked float32 logits [B, V] of sequence position `pos` from
    full uncached forwards (guidance-blended), computing the head at that
    position only."""

    def one(null_cond_prob):
        _, out = model.trunk(text, image, null_cond_prob=null_cond_prob)
        return model.to_logits(out[:, pos]).float().masked_fill(blocked, NEG_MASK_VALUE)

    row = one(0.0)
    if cond_scale == 1:
        return row
    null = one(1.0)
    return null + (row - null) * cond_scale


def _sample(filtered, temperatures, noise, margins, i):
    """Gumbel-max of one position; with `margins`, record the top-2 gap of
    the noised scores there."""
    if margins is not None:
        t = temperatures.float().clamp(min=1e-4)[:, None]
        top2 = torch.topk(filtered.float() / t + noise, 2, dim=-1).values
        margins[:, i] = (top2[:, 0] - top2[:, 1]).cpu()
    return gumbel_sample_per_row(filtered, temperatures, noise)


@torch.inference_mode()
def generate_images(
    model: DALLE,
    text: torch.Tensor,
    seed,
    filter_thres: float = 0.5,
    temperature: float = 1.0,
    cond_scale: float = 1.0,
    init_image_tokens=None,
    num_init_img_tokens: Optional[int] = None,
    return_margins: bool = False,
):
    """The uncached sampling oracle (the reference's `generate_images`):
    each sampled image position runs full forwards over the fixed-shape
    token buffer (causality makes the unsampled suffix irrelevant), with
    the same filter, noise and priming as `generate_images_cached`, so the
    two sample the same tokens wherever their logits agree. Primed
    positions are fed, and their forwards skipped (the reference computes
    and discards them). Returns tokens [B, image_seq_len] int64; with
    `return_margins`, also the top-2 gap of the noised scores [B,
    image_seq_len] float32 (NaN where primed)."""
    b = text.shape[0]
    device = text.device
    img_tokens, primed = _primed_image_tokens(model, b, init_image_tokens, num_init_img_tokens, device)
    seeds = _batch_seeds(seed, b)
    temps = torch.full((b,), float(temperature), dtype=torch.float32, device=device)
    blocked = (torch.arange(model.total_tokens, device=device) < model.total_text_tokens)[None]
    margins = torch.full((b, model.image_seq_len), float("nan")) if return_margins else None
    for i in range(primed, model.image_seq_len):
        row = _logits_at(model, text, img_tokens, model.text_seq_len + i, blocked, cond_scale)
        noise = gumbel_noise(seeds, i, model.total_tokens, device)
        sample = _sample(top_k_filter(row, filter_thres), temps, noise, margins, i)
        img_tokens[:, i] = sample - model.total_text_tokens
    return (img_tokens, margins) if return_margins else img_tokens


@torch.inference_mode()
def generate_texts(
    model: DALLE,
    text_prefix: torch.Tensor,
    prefix_len: int,
    seed,
    filter_thres: float = 0.5,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Autoregressive text completion (the reference's `generate_texts`):
    positions from `prefix_len` on are sampled, each from a full uncached
    forward over the text (position i predicts text token i), with the
    noise of `generate_images` at text position i. A sampled id 0 reads
    as padding afterwards, as in the reference. Returns [B, text_seq_len]
    int64 ids."""
    text = text_prefix.to(torch.long).clone()
    b, device = text.shape[0], text.device
    seeds = _batch_seeds(seed, b)
    temps = torch.full((b,), float(temperature), dtype=torch.float32, device=device)
    blocked = (torch.arange(model.total_tokens, device=device) >= model.total_text_tokens)[None]
    for i in range(int(prefix_len), model.text_seq_len):
        row = _logits_at(model, text, None, i, blocked, 1.0)
        noise = gumbel_noise(seeds, i, model.total_tokens, device)
        text[:, i] = _sample(top_k_filter(row, filter_thres), temps, noise, None, i)
    return text


# ------------------------------------------------------ continuous batching
#
# Slot ops of the continuous engine (the reference's `init_slot_state`,
# `prefill_into_slots`, `release_slots`, `decode_image_chunk`): one
# persistent decode state of `max_batch` cache slots, each row at its own
# position (the per-row cache index, token-shift ring slots, image position
# and sampling parameters). A request's tokens are the same alone, padded
# or admitted mid-flight, because every per-row quantity is threaded per
# slot and row i's noise is keyed by (seed, image position) alone. The
# state is updated in place: one copy of the slot cache stays alive.
#
# The state keeps host mirrors ("host") of each slot's image position,
# liveness, seed and keep count, advanced by the same rules as the device
# tensors: the noise keys and the top-k bound come from them, so a chunk
# reads nothing back from the device.


@torch.inference_mode()
def init_slot_state(model: DALLE, max_batch: int) -> dict:
    """Empty decode state for `max_batch` slots on the model's device.
    Free slots hold zeros; `prefill_into_slots` overwrites an admitted
    slot wholesale (every cache position), so nothing leaks between the
    occupants of a slot, and `active` gates which rows advance."""
    cache = init_decode_cache(model, max_batch, per_row=True)
    return {"cache": cache, **_slot_control(model, max_batch)}


def _slot_control(model: DALLE, max_batch: int) -> dict:
    """The per-slot decode state beside the cache, and its host mirrors."""
    s = int(max_batch)
    device = model.text_emb.weight.device
    return {
        # pending next-position logits per slot: what the next sample draws
        # from, written by prefill and refreshed every decode step
        "row": torch.zeros((s, model.total_tokens), dtype=torch.float32, device=device),
        "img_tokens": torch.zeros((s, model.image_seq_len), dtype=torch.int32, device=device),
        "img_pos": torch.zeros(s, dtype=torch.int32, device=device),
        "active": torch.zeros(s, dtype=torch.bool, device=device),
        "temps": torch.ones(s, dtype=torch.float32, device=device),
        "keep_k": torch.ones(s, dtype=torch.int32, device=device),
        "host": {
            "img_pos": np.zeros(s, np.int64),
            "active": np.zeros(s, bool),
            "seeds": np.zeros(s, np.int64),
            "keep_k": np.ones(s, np.int64),
        },
    }


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; to a card through pinned memory without
    blocking the host (no synchronization inside a decode chunk)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _with_block_bitmap(cache: dict, bitmaps: torch.Tensor, model: DALLE) -> None:
    """Put layer i's decode-sparsity bitmap bitmaps[i] ([B, nb] int32) and
    the bitmap's block width into every layer's attention cache, in place."""
    block = model.decode_sparse_block or DECODE_SPARSE_BLOCK
    for i in range(model.depth):
        attn = cache[f"layer_{i}"]["attn"]
        attn["block_bitmap"] = bitmaps[i]
        attn["sparse_block"] = block


def _without_block_bitmap(cache: dict) -> None:
    """Take the bitmap entries out again: the persistent slot state holds
    none (the policy's tables are host state, made per dispatch)."""
    for layer in cache.values():
        layer["attn"].pop("block_bitmap", None)
        layer["attn"].pop("sparse_block", None)


@torch.inference_mode()
def prefill_into_slots(
    model: DALLE,
    state: dict,
    texts: np.ndarray,
    slots: Sequence[int],
    seeds: Sequence[int],
    temperatures: Sequence[float],
    keep_ks: Sequence[int],
    block_bitmap: Optional[np.ndarray] = None,
) -> dict:
    """Admit R prompts (`texts` [R, text_seq_len]) into their slots in one
    prefill at batch R — the same `decode_prefill` the micro engine runs,
    so per-row numerics match it — then copy each row's K/V (+ scales),
    token-shift rings, pending logits and sampling parameters into its
    slot. Fewer real prompts than R are padded by repeating a real (slot,
    prompt) row: the duplicates write the same slot with the same content.
    `block_bitmap` ([depth, R, nb] int32, all ones from the policy) sends
    the prefill through the block-sparse kernel. `index` leaves are not
    copied: the chunk stamps them from `img_pos`. Returns `state`."""
    device = state["row"].device
    r = len(texts)
    cache = init_decode_cache(model, r)
    if block_bitmap is not None:
        _with_block_bitmap(cache, _to_device(block_bitmap, device), model)
    rows, cache = model.decode_prefill(_to_device(np.asarray(texts), device), cache)
    idx = _to_device(np.asarray(slots, np.int64), device)
    for name, layer in state["cache"].items():
        for key, leaf in layer["attn"].items():
            if key != "index":
                leaf.index_copy_(0, idx, cache[name]["attn"][key])
    _admit_slot_rows(state, idx, slots, rows, _extract_rings(cache), seeds, temperatures, keep_ks)
    return state


def _extract_rings(cache: dict) -> dict:
    """{layer: {ring name: [R, fmap, dim]}} of a fresh prefill cache: the
    part of a prefix's post-prefill state that is not in K/V (empty when
    the model does not shift tokens)."""
    out = {}
    for name, layer in cache.items():
        rings = {key: layer[key] for key in ("shift_attn", "shift_ff") if key in layer}
        if rings:
            out[name] = rings
    return out


def _admit_slot_rows(state, idx, slots, rows, rings, seeds, temperatures, keep_ks) -> None:
    """Everything of an admission but K/V: per slot (idx the [R] slot
    tensor) the shift rings, pending logits and sampling state from row r
    of `rows` [R, V] and `rings`, and the host mirrors."""
    device = state["row"].device
    for name, layer_rings in rings.items():
        for key, src in layer_rings.items():
            state["cache"][name][key].index_copy_(0, idx, src.to(state["cache"][name][key].dtype))
    state["row"].index_copy_(0, idx, rows.float())
    state["img_tokens"].index_fill_(0, idx, 0)
    state["img_pos"].index_fill_(0, idx, 0)
    state["active"].index_fill_(0, idx, True)
    state["temps"].index_copy_(0, idx, _to_device(np.asarray(temperatures, np.float32), device))
    state["keep_k"].index_copy_(0, idx, _to_device(np.asarray(keep_ks, np.int32), device))
    host = state["host"]
    host["img_pos"][list(slots)] = 0
    host["active"][list(slots)] = True
    host["seeds"][list(slots)] = seeds
    host["keep_k"][list(slots)] = keep_ks


@torch.inference_mode()
def release_slots(state: dict, slots: Sequence[int]) -> dict:
    """Deactivate `slots`: the chunk stops advancing them. Returns `state`."""
    slots = list(slots)
    if slots:
        idx = _to_device(np.asarray(slots, np.int64), state["active"].device)
        state["active"].index_fill_(0, idx, False)
        state["host"]["active"][slots] = False
    return state


@torch.inference_mode()
def decode_image_chunk(
    model: DALLE,
    state: dict,
    chunk: int,
    block_bitmap: Optional[np.ndarray] = None,
    page_table: Optional[np.ndarray] = None,
    paged_impl: Optional[str] = None,
) -> dict:
    """Advance every live slot by up to `chunk` tokens.

    Each step samples one token per live row from its pending logits
    (noise keyed by the row's (seed, image position), its own temperature
    and keep count), writes it at the row's image position and feeds it
    through the transformer at the row's own cache position. Rows that
    reach `image_seq_len` freeze (tokens, logits and position stop
    advancing) until the host retires them; free slots compute along as
    padding but keep nothing. `block_bitmap` ([depth, max_batch, nb] int32)
    arms decode sparsity for the chunk; `page_table` ([max_batch,
    n_pages] int32 host array) reads and writes a paged state's pools
    through it, with `paged_impl` the `paged_decode_attention` impl.
    Launches work only: no device value is read back. Returns `state`."""
    text_len = model.text_seq_len + 1  # <bos> + text prefix
    seq = model.image_seq_len
    host = state["host"]
    cache = state["cache"]
    device = state["row"].device
    blocked = (torch.arange(model.total_tokens, device=device) < model.total_text_tokens)[None]
    k_max = int(host["keep_k"].max())
    seeds = [int(s) for s in host["seeds"]]
    if block_bitmap is not None:
        _with_block_bitmap(cache, _to_device(block_bitmap, device), model)
    if page_table is not None:
        _with_page_table(cache, _to_device(np.asarray(page_table, np.int32), device), paged_impl)
    try:
        for _ in range(int(chunk)):
            img_pos = state["img_pos"]
            live = state["active"] & (img_pos < seq)
            masked = state["row"].masked_fill(blocked, NEG_MASK_VALUE)
            filtered = top_k_filter_per_row(masked, state["keep_k"], k_max=k_max)
            noise = gumbel_noise(seeds, [int(p) for p in host["img_pos"]], model.total_tokens, device)
            sample = gumbel_sample_per_row(filtered, state["temps"], noise) - model.total_text_tokens
            col = img_pos.to(torch.long).clamp(0, seq - 1)[:, None]
            written = state["img_tokens"].scatter(1, col, sample[:, None].to(torch.int32))
            state["img_tokens"] = torch.where(live[:, None], written, state["img_tokens"])
            set_decode_cache_index(cache, img_pos + text_len)
            new_row, _ = model.decode_image_step(sample, img_pos, cache)
            state["row"] = torch.where(live[:, None], new_row, state["row"])
            state["img_pos"] = torch.where(live, img_pos + 1, img_pos)
            host["img_pos"] += host["active"] & (host["img_pos"] < seq)
    finally:
        _without_block_bitmap(cache)
        _without_page_table(cache)
    return state


# ------------------------------------------------------------ paged cache
#
# The paged slot ops (the reference's of the same names): K/V in page
# pools shared by all slots, with host-owned per-row page tables
# (`serving/paging.py`) handed to each chunk; the prefill still runs a
# slotted cache of the wave's rows (kernel 1, or 3 under a policy) and is
# scattered into pages. Identical caption prefixes share immutable text
# pages, and a full-prompt hit admits from its cached sidecar (pending
# logits + shift rings) with no transformer dispatch. The per-slot
# control state and its host mirrors are the slotted state's.


def _with_page_table(cache: dict, page_table: torch.Tensor, impl: Optional[str]) -> None:
    """Put the [B, n_pages] table and the paged decode impl into every
    layer's attention cache, in place."""
    for layer in cache.values():
        layer["attn"]["page_table"] = page_table
        layer["attn"]["paged_impl"] = impl


def _without_page_table(cache: dict) -> None:
    for layer in cache.values():
        layer["attn"].pop("page_table", None)
        layer["attn"].pop("paged_impl", None)


@torch.inference_mode()
def init_paged_slot_state(model: DALLE, max_batch: int, n_pages: int, page_size: int) -> dict:
    """Empty paged decode state: `init_slot_state`'s per-slot control
    state, with K/V in pools of `n_pages` pages of `page_size` positions
    (page 0 is the serving layer's garbage page, never allocated)."""
    cache = make_paged_decode_cache(
        depth=model.depth,
        batch=int(max_batch),
        n_pages=int(n_pages),
        page_size=int(page_size),
        heads=model.heads,
        dim_head=model.dim_head,
        dim=model.dim,
        image_fmap_size=model.image_fmap_size,
        shift_tokens=model.shift_tokens,
        dtype=model.dtype,
        device=model.text_emb.weight.device,
        kv_dtype=model.kv_dtype,
    )
    return {"cache": cache, **_slot_control(model, max_batch)}


def _text_blocks(leaf: torch.Tensor, n_blocks: int, page_size: int) -> torch.Tensor:
    """Rows' first `n_blocks` blocks of a prefill cache leaf [R, H, L(,
    D)], zero-padded past L, as pages [R, n_blocks, H, page(, D)]."""
    r, h, length = leaf.shape[:3]
    need = n_blocks * page_size
    if need > length:
        pad = [0, 0] * (leaf.dim() - 3) + [0, need - length]
        leaf = F.pad(leaf, pad)
    blocks = leaf[:, :, :need].reshape(r, h, n_blocks, page_size, *leaf.shape[3:])
    return blocks.transpose(1, 2)


@torch.inference_mode()
def prefill_into_slots_paged(
    model: DALLE,
    state: dict,
    texts: np.ndarray,
    slots: Sequence[int],
    seeds: Sequence[int],
    temperatures: Sequence[float],
    keep_ks: Sequence[int],
    page_rows: np.ndarray,
    partial_dst: np.ndarray,
    page_size: int,
    block_bitmap: Optional[np.ndarray] = None,
) -> dict:
    """Paged admission of R prompts: `prefill_into_slots`' prefill at
    batch R, its K/V (+ scales) scattered into pages. `page_rows` [R,
    n_text_pages] names row r's page for each text block (shared prefix
    blocks may name pages other rows or the prefix cache map: the wave
    rewrites them with identical bytes; padding rows repeat row 0's pages
    likewise); `partial_dst` [R] is an extra page per row for its last
    text block, the prefix cache's snapshot of the divergence block
    (page 0, the garbage page, for rows not registering). Returns the
    sidecar {"row": [R, V] pending logits, "rings": {layer: {ring: [R,
    fmap, dim]}}} a later full-prompt hit restores."""
    device = state["row"].device
    r = len(texts)
    page_rows = np.asarray(page_rows, np.int64)
    n_text_pages = page_rows.shape[1]
    cache = init_decode_cache(model, r)
    if block_bitmap is not None:
        _with_block_bitmap(cache, _to_device(block_bitmap, device), model)
    rows, cache = model.decode_prefill(_to_device(np.asarray(texts), device), cache)
    pages = _to_device(page_rows.reshape(-1), device)
    snap = _to_device(np.asarray(partial_dst, np.int64), device)
    for name, layer in state["cache"].items():
        for key, pool in layer["attn"].items():
            if key == "index":
                continue
            blocks = _text_blocks(cache[name]["attn"][key], n_text_pages, page_size)
            pool.index_copy_(0, pages, blocks.reshape(-1, *pool.shape[1:]).to(pool.dtype))
            pool.index_copy_(0, snap, blocks[:, -1].to(pool.dtype))
    idx = _to_device(np.asarray(slots, np.int64), device)
    rings = _extract_rings(cache)
    _admit_slot_rows(state, idx, slots, rows, rings, seeds, temperatures, keep_ks)
    return {"row": rows.float(), "rings": rings}


def slice_prefix_sidecar(sidecar: dict, r: int) -> dict:
    """Row `r` of a wave's sidecar, as tensors of its own (a cached entry
    does not keep the whole wave's alive)."""
    return {
        "row": sidecar["row"][r].clone(),
        "rings": {
            name: {key: t[r].clone() for key, t in rings.items()}
            for name, rings in sidecar["rings"].items()
        },
    }


@torch.inference_mode()
def admit_cached_prefix(
    model: DALLE,
    state: dict,
    slot: int,
    sidecar: dict,
    seed: int,
    temperature: float,
    keep_k: int,
    partial_src: int,
    partial_dst: int,
    page_size: int,
) -> dict:
    """Admit a full prefix-cache hit into `slot` with no transformer
    dispatch: the prefix's text pages are already in the row's table
    (the host mapped them); this copies the cache's snapshot of the
    divergence block (`partial_src`) to the row's private page
    (`partial_dst`) — skipped when the text ends on a page boundary —
    and restores the sidecar's pending logits and shift rings and the
    slot's sampling state. Returns `state`."""
    if (model.text_seq_len + 1) % page_size:
        for layer in state["cache"].values():
            for key, pool in layer["attn"].items():
                if key != "index":
                    pool[int(partial_dst)].copy_(pool[int(partial_src)])
    idx = _to_device(np.asarray([slot], np.int64), state["row"].device)
    rings = {
        name: {key: t[None] for key, t in layer_rings.items()}
        for name, layer_rings in sidecar["rings"].items()
    }
    _admit_slot_rows(state, idx, [slot], sidecar["row"][None], rings, [seed], [temperature], [keep_k])
    return state


def decode_image_chunk_paged(
    model: DALLE,
    state: dict,
    chunk: int,
    page_table: np.ndarray,
    block_bitmap: Optional[np.ndarray] = None,
    paged_impl: Optional[str] = None,
) -> dict:
    """`decode_image_chunk` (the same body) on a paged state: every row's
    K/V reads and writes go through `page_table` [max_batch, n_pages]
    (host int32, uploaded through pinned memory without blocking)."""
    return decode_image_chunk(
        model, state, chunk, block_bitmap=block_bitmap, page_table=page_table,
        paged_impl=paged_impl,
    )
