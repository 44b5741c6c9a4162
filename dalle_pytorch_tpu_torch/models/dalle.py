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
`decode_image_chunk_paged`), and the mid-decode resume (`decode_resume`,
`resume_into_slots`, `resume_into_slots_paged`). The cached decode runs
over a list of shards (`prefill_shards`, `image_step_shards`,
`resume_shards`): the model itself, or a tensor-parallel model's shards
(`parallel/tensor_parallel.py`), and every slot op takes either. Null
conditioning is all-pad text, which the caller passes: the training loss
draws the blanked rows (`training/steps.py:make_dalle_loss`), guidance
blanks every row; dropout uses torch's global generator.

The port holds its weights in the module (the reference keeps them in a
separate parameter tree; `weights.py` carries a tree across). A model's
floating dtype is its parameters' dtype (`model.to(torch.bfloat16)`);
logits come out in float32. Sampling runs as a Python loop over image
positions; the KV cache is updated in place.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.models.attention import DECODE_SPARSE_BLOCK
from dalle_pytorch_tpu_torch.models.transformer import (
    LayerNorm,
    Transformer,
    cached_forward,
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
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TensorParallelDALLE

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
        sp_mesh=None,
    ):
        """Arguments as the reference's fields (`sp_mesh`, a `TrainMesh`, is
        the mesh of attn_impl="ring"). `img_loss_coeff` None takes
        `loss_img_weight`; `fused_ce` computes the loss without
        materializing [B, N, V] logits (`ops/losses.py`). `kv_dtype="int8"`
        gives decode caches an int8 K/V store; `decode_sparse_block` is the
        KV block width of decode-sparsity bitmaps (None: the attention
        module's DECODE_SPARSE_BLOCK)."""
        kwargs = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        super().__init__()
        #: the constructor's arguments (a tensor-parallel shard is built from them)
        self.init_kwargs = kwargs
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
            sp_mesh=sp_mesh,
        )
        self.logits_norm = LayerNorm(dim)
        if share_input_output_emb:
            self.logits_bias = nn.Parameter(torch.zeros(self.total_tokens))
        else:
            self.logits_dense = nn.Linear(dim, self.total_tokens)

    def extra_repr(self) -> str:
        """The decode-relevant settings the submodules' repr does not show
        (a serving engine's resume fingerprint hashes the repr)."""
        return (
            f"attn_types={self.attn_types}, attn_impl={self.attn_impl!r}, "
            f"stable={self.stable}, shift_tokens={self.shift_tokens}, "
            f"rotary_emb={self.rotary_emb}, kv_dtype={self.kv_dtype!r}, "
            f"decode_sparse_block={self.decode_sparse_block}, dtype={self.dtype}"
        )

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

    def embed_text(self, text: torch.Tensor):
        """Unique-pad remap + <bos>: (ids [B, T+1], embeddings [B, T+1, dim])."""
        text = self.text_ids(text)
        tokens = self.text_emb(text)
        if not self.rotary_emb:
            tokens = tokens + self.text_pos_emb.weight[None]
        return text, tokens

    def text_ids(self, text: torch.Tensor) -> torch.Tensor:
        """The ids `embed_text` looks up: [B, T + 1], pads remapped, <bos>."""
        if text.shape[-1] != self.text_seq_len:
            raise ValueError(
                f"text length {text.shape[-1]} != text_seq_len {self.text_seq_len}"
            )
        text = text.long()
        text_range = torch.arange(self.text_seq_len, device=text.device) + (
            self.total_text_tokens - self.text_seq_len
        )
        text = torch.where(text == 0, text_range, text)
        return F.pad(text, (1, 0))  # <bos> = 0

    def _divide_max(self, out: torch.Tensor) -> torch.Tensor:
        return out / out.amax(dim=-1, keepdim=True).detach()

    def _logits_kernel(self):
        """(kernel [D, V], bias [V] or None) of the logits head."""
        if self.share_input_output_emb:
            kernel = torch.cat([self.text_emb.weight, self.image_emb.weight], dim=0).t()
            return kernel, self.logits_bias
        return self.logits_dense.weight.t(), self.logits_dense.bias

    def weights_read_outside_modules(self) -> Tuple[str, ...]:
        """The parameters this model reads outside their own module's
        forward, where a hook around that forward (`parallel/fsdp.py`) does
        not see the read: the text positions (`embed_text`) and the logits
        head's kernel where `_logits_kernel` reads it (the tied embeddings,
        or the dense head of the fused loss)."""
        names = () if self.rotary_emb else ("text_pos_emb.weight",)
        if self.share_input_output_emb:
            return names + ("text_emb.weight", "image_emb.weight")
        return names + (("logits_dense.weight",) if self.fused_ce else ())

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
    ):
        """text [B, text_seq_len] ids; image [B, <= image_seq_len] codebook
        ids. Returns masked float32 logits [B, N, V], or with `return_loss`
        (loss, accuracy): the split cross-entropy of the forward (text ->
        image) or, with `inverse_mapping`, the inverse (image first) objective
        and its 3-token accuracy (None for the forward one)."""
        text, out = self.trunk(text, image, inverse_mapping, reverse_model)
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
    ):
        """The uncached trunk of `forward`: (text ids with <bos> [B, T + 1],
        the final hidden states [B, N, dim]), N = min(tokens, total_seq_len)."""
        text, tokens = self.embed_text(text)
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
        rows = prefill_shards(TensorParallelDALLE(self), text, [cache])
        return rows[0], cache

    def decode_image_step(self, img_token: torch.Tensor, image_pos, cache: dict):
        """Feed one image token at grid index `image_pos` (a Python int, or
        a [B] tensor of per-row positions with a per-row cache); returns
        (logits for the next position [B, V] float32, cache)."""
        rows = image_step_shards(TensorParallelDALLE(self), img_token, [image_pos], [cache])
        return rows[0], cache

    def image_position(self, emb: torch.Tensor, image_pos) -> torch.Tensor:
        """One image token's embeddings [B, 1, dim] plus the axial positional
        embedding at `image_pos` (an int or a [B] tensor), without rotary."""
        if self.rotary_emb:
            return emb
        table = self.image_pos_emb()
        if torch.is_tensor(image_pos):
            rows = image_pos.to(torch.long).clamp(0, self.image_seq_len - 1)
            return emb + table[rows][:, None]
        p = min(max(int(image_pos), 0), self.image_seq_len - 1)
        return emb + table[p][None, None]

    def decode_resume(self, text: torch.Tensor, image_tokens: torch.Tensor, image_pos, cache: dict):
        """Teacher-forced re-prefill of prompt + generated image prefix in
        one cached forward: a row resuming at image position k pays one
        parallel prefill instead of k decode steps.

        `image_tokens` [B, image_seq_len] holds each row's generated tokens
        (zeros past its prefix), `image_pos` [B] the resume positions k
        (a tensor or a sequence of ints). The forward runs the incremental
        path's per-position math (embeddings as `decode_image_step`, the
        batch token shift, causal cached attention from position 0) over
        text_len + image_seq_len - 1 positions, from a fresh cache: the
        last image token's K/V is never read. K/V past a row's k comes
        from the zero padding; decode never reads past the index it stamps
        and overwrites those positions as it advances. Shift rings are
        rebuilt per row below text_len + k (`shift_ring_from_prefill_at`,
        through each layer's "ring_end" entry, taken out again). Returns
        (pending logits for each row's position k [B, V] float32, cache);
        at k = 0 this is `decode_prefill`."""
        rows = resume_shards(TensorParallelDALLE(self), text, image_tokens, image_pos, [cache])
        return rows[0], cache


# ------------------------------------------------------------ cached decode
#
# The cached decode ops over the shards of a `TensorParallelDALLE`
# (`parallel/tensor_parallel.py`): the model itself as its one shard (the
# `DALLE.decode_*` methods above and every slot op given a DALLE), or a
# tensor-parallel model's shards (heads, FF hidden units and vocabularies
# split, the rest whole on every shard), the counterpart of the JAX
# package's sharded serving programs. Each shard keeps a decode cache (its
# heads' K/V); the embeddings are vocabulary-parallel and sum exactly, the
# residual stream is the same on every shard, and each returns its columns
# of the logits (`TensorParallelDALLE.gather_logits` joins them).


def _text_tokens(tp, text: torch.Tensor) -> list:
    """Unique-pad remap + <bos> of `text`, embedded on every shard."""
    tokens = tp.embed("text_emb", tp.shards[0].text_ids(text))
    if not tp.shards[0].rotary_emb:
        tokens = [t + sh.text_pos_emb.weight[None] for sh, t in zip(tp.shards, tokens)]
    return tokens


def _shard_logits(tp, outs) -> list:
    return [sh.to_logits(o)[:, 0].float() for sh, o in zip(tp.shards, outs)]


def _trunk(tp, xs, caches) -> list:
    return cached_forward([sh.transformer for sh in tp.shards], xs, caches)


def prefill_shards(tp, text: torch.Tensor, caches: list) -> list:
    """`DALLE.decode_prefill` over the shards: bos + text through the trunk
    into every shard's cache from position 0. Returns each shard's logits
    columns for image position 0 [B, V_s] float32."""
    outs = _trunk(tp, _text_tokens(tp, text), caches)
    return _shard_logits(tp, [o[:, -1:] for o in outs])


def image_step_shards(tp, img_token: torch.Tensor, image_pos: list, caches: list) -> list:
    """`DALLE.decode_image_step` over the shards: one image token per row,
    image_pos[s] the positions on shard s (ints or [B] tensors)."""
    embs = tp.embed("image_emb", img_token[:, None].long())
    embs = [sh.image_position(e, p) for sh, e, p in zip(tp.shards, embs, image_pos)]
    return _shard_logits(tp, _trunk(tp, embs, caches))


def resume_shards(tp, text: torch.Tensor, image_tokens: torch.Tensor, image_pos, caches: list) -> list:
    """`DALLE.decode_resume` over the shards: prompt + generated prefix in
    one teacher-forced cached forward into every shard's fresh cache."""
    sh0 = tp.shards[0]
    seq_len = sh0.image_seq_len
    tokens = _text_tokens(tp, text)
    text_len = tokens[0].shape[1]  # text_seq_len + 1 (<bos>)
    imgs = tp.embed("image_emb", image_tokens[:, : seq_len - 1].long())
    if not sh0.rotary_emb:
        imgs = [i + sh.image_pos_emb()[None, : seq_len - 1] for sh, i in zip(tp.shards, imgs)]
    seqs = [torch.cat([t, i.to(t.dtype)], dim=1) for t, i in zip(tokens, imgs)]
    image_pos = torch.as_tensor(image_pos, dtype=torch.long)
    positions = [image_pos.to(sq.device) for sq in seqs]
    for cache, p in zip(caches, positions):
        _with_ring_end(cache, text_len + p)
    try:
        outs = _trunk(tp, seqs, caches)
    finally:
        for cache in caches:
            _without_ring_end(cache)
    # the pending logits of position k are the output of feeding token
    # k - 1, at sequence position text_len - 1 + k
    sel = [o[torch.arange(o.shape[0], device=o.device), text_len - 1 + p][:, None]
           for o, p in zip(outs, positions)]
    return _shard_logits(tp, sel)


def _with_ring_end(cache: dict, ring_end: torch.Tensor) -> None:
    """Put the per-row resume window `ring_end` [B] into every layer of a
    decode cache, in place: `Transformer._shift` then rebuilds each row's
    rings below its own end (`decode_resume`)."""
    for layer in cache.values():
        layer["ring_end"] = ring_end


def _without_ring_end(cache: dict) -> None:
    for layer in cache.values():
        layer.pop("ring_end", None)


def init_decode_cache(model: DALLE, batch: int, per_row: bool = False, device=None) -> dict:
    """Fixed-shape cache of total_seq_len + 1 positions, in the model's
    dtype (K/V in `model.kv_dtype` when set) and on its device or `device`
    (the final image token is fed too; its write lands in the spare
    slot)."""
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
        device=model.text_emb.weight.device if device is None else device,
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
    null = model(torch.zeros_like(text), image)
    return null + (logits - null) * cond_scale


def _logits_at(model: DALLE, text, image, pos: int, blocked, cond_scale: float) -> torch.Tensor:
    """The masked float32 logits [B, V] of sequence position `pos` from
    full uncached forwards (guidance-blended), computing the head at that
    position only."""

    def one(text):
        _, out = model.trunk(text, image)
        return model.to_logits(out[:, pos]).float().masked_fill(blocked, NEG_MASK_VALUE)

    row = one(text)
    if cond_scale == 1:
        return row
    null = one(torch.zeros_like(text))
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
def init_slot_state(model: DALLE, max_batch: int, device=None) -> dict:
    """Empty decode state for `max_batch` slots on the model's device (or
    `device`). Free slots hold zeros; `prefill_into_slots` overwrites an
    admitted slot wholesale (every cache position), so nothing leaks
    between the occupants of a slot, and `active` gates which rows
    advance."""
    cache = init_decode_cache(model, max_batch, per_row=True, device=device)
    return {"cache": cache, **_slot_control(model, max_batch, device)}


def _slot_control(model: DALLE, max_batch: int, device=None) -> dict:
    """The per-slot decode state beside the cache, and its host mirrors."""
    s = int(max_batch)
    device = model.text_emb.weight.device if device is None else device
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
    copied: the chunk stamps them from `img_pos`. `model` and `state` may
    be a `TensorParallelDALLE` and the state it placed (every slot op
    takes either pair, `_shards_of`). Returns `state`."""
    tp, states = _shards_of(model, state)
    caches = _wave_caches(tp, len(texts), block_bitmap)
    rows = prefill_shards(tp, _to_device(np.asarray(texts), tp.devices[0]), caches)
    for st, cache, row in zip(states, caches, rows):
        idx = _to_device(np.asarray(slots, np.int64), st["row"].device)
        _copy_kv(st["cache"], cache, idx)
        _admit_slot_rows(st, idx, slots, row, _extract_rings(cache), seeds, temperatures, keep_ks)
    return state


def shard_states(state: dict) -> list:
    """The per-shard states of a slot state: a placed state's
    ("shards"), or the one state itself."""
    return state["shards"] if "shards" in state else [state]


def _shards_of(model, state: dict):
    """(the shards, their states) of a slot op's model and state: a DALLE
    and its state (one shard, the model itself), or a `TensorParallelDALLE`
    and the {"shards", "host"} state of its `place_state`."""
    tp = model if isinstance(model, TensorParallelDALLE) else TensorParallelDALLE(model)
    return tp, shard_states(state)


def _wave_caches(tp, r: int, block_bitmap=None) -> list:
    """Fresh decode caches of a wave of `r` rows, one per shard on its
    device, with the policy's bitmaps in place."""
    caches = [init_decode_cache(sh, r) for sh in tp.shards]
    if block_bitmap is not None:
        for sh, dev, cache in zip(tp.shards, tp.devices, caches):
            _with_block_bitmap(cache, _to_device(block_bitmap, dev), sh)
    return caches


def _resume_wave(tp, texts, img_tokens, img_pos):
    """`resume_shards` of a resume wave into fresh caches: (each shard's
    pending logits, caches)."""
    dev = tp.devices[0]
    caches = _wave_caches(tp, len(texts))
    rows = resume_shards(
        tp, _to_device(np.asarray(texts), dev), _to_device(np.asarray(img_tokens, np.int32), dev),
        _to_device(np.asarray(img_pos, np.int64), dev), caches,
    )
    return rows, caches


def _copy_kv(slot_cache: dict, cache: dict, idx: torch.Tensor) -> None:
    """Copy a wave's K/V (+ scales) rows into slots `idx` of the slot cache
    (`index` leaves are not copied: the chunk stamps them)."""
    for name, layer in slot_cache.items():
        for key, leaf in layer["attn"].items():
            if key != "index":
                leaf.index_copy_(0, idx, cache[name]["attn"][key])


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


def _admit_slot_rows(
    state, idx, slots, rows, rings, seeds, temperatures, keep_ks, img_tokens=None, img_pos=None
) -> None:
    """Everything of an admission but K/V: per slot (idx the [R] slot
    tensor) the shift rings, pending logits and sampling state from row r
    of `rows` [R, V] and `rings`, and the host mirrors. A resume also
    gives each row's token buffer `img_tokens` [R, image_seq_len] and
    position `img_pos` [R] (host arrays); a prefill starts at 0."""
    device = state["row"].device
    for name, layer_rings in rings.items():
        for key, src in layer_rings.items():
            state["cache"][name][key].index_copy_(0, idx, src.to(state["cache"][name][key].dtype))
    state["row"].index_copy_(0, idx, rows.float())
    if img_pos is None:
        state["img_tokens"].index_fill_(0, idx, 0)
        state["img_pos"].index_fill_(0, idx, 0)
        img_pos = 0
    else:
        img_tokens = np.asarray(img_tokens, np.int32)
        img_pos = np.asarray(img_pos, np.int64)
        state["img_tokens"].index_copy_(0, idx, _to_device(img_tokens, device))
        state["img_pos"].index_copy_(0, idx, _to_device(img_pos.astype(np.int32), device))
    state["active"].index_fill_(0, idx, True)
    state["temps"].index_copy_(0, idx, _to_device(np.asarray(temperatures, np.float32), device))
    state["keep_k"].index_copy_(0, idx, _to_device(np.asarray(keep_ks, np.int32), device))
    host = state["host"]
    # padding rows repeat a real (slot, row) pair, so duplicates agree
    host["img_pos"][list(slots)] = img_pos
    host["active"][list(slots)] = True
    host["seeds"][list(slots)] = seeds
    host["keep_k"][list(slots)] = keep_ks


@torch.inference_mode()
def resume_into_slots(
    model: DALLE,
    state: dict,
    texts: np.ndarray,
    img_tokens: np.ndarray,
    img_pos: np.ndarray,
    slots: Sequence[int],
    seeds: Sequence[int],
    temperatures: Sequence[float],
    keep_ks: Sequence[int],
) -> dict:
    """Admit R mid-decode rows into their slots in one dispatch: like
    `prefill_into_slots`, but each row arrives with its generated prefix,
    `img_tokens` [R, image_seq_len] (zeros past the prefix) and resume
    positions `img_pos` [R]. `DALLE.decode_resume` re-prefills prompt +
    prefix in one teacher-forced forward, so K/V, shift rings, pending
    logits and position land where the incremental decode would have
    left them and the next chunk continues from each row's k. Padding and
    copy semantics are `prefill_into_slots`' (`index` leaves not copied).
    Returns `state`."""
    tp, states = _shards_of(model, state)
    rows, caches = _resume_wave(tp, texts, img_tokens, img_pos)
    for st, cache, row in zip(states, caches, rows):
        idx = _to_device(np.asarray(slots, np.int64), st["row"].device)
        _copy_kv(st["cache"], cache, idx)
        _admit_slot_rows(st, idx, slots, row, _extract_rings(cache), seeds, temperatures, keep_ks,
                         img_tokens=img_tokens, img_pos=img_pos)
    return state


@torch.inference_mode()
def release_slots(state: dict, slots: Sequence[int]) -> dict:
    """Deactivate `slots` (on every shard): the chunk stops advancing them.
    Returns `state`."""
    slots = list(slots)
    if slots:
        for st in shard_states(state):
            idx = _to_device(np.asarray(slots, np.int64), st["active"].device)
            st["active"].index_fill_(0, idx, False)
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
    Launches work only: no device value is read back. Over shards, each
    step gathers the pending rows' vocabulary slices to shard 0, draws
    there once, hands the tokens to every shard, and every shard advances
    its copy of the per-row state alike. Returns `state`."""
    tp, states = _shards_of(model, state)
    sh0, st0 = tp.shards[0], states[0]
    seq = sh0.image_seq_len
    host = state["host"]
    blocked = (torch.arange(sh0.total_tokens, device=tp.devices[0]) < sh0.total_text_tokens)[None]
    k_max = int(host["keep_k"].max())
    seeds = [int(s) for s in host["seeds"]]
    caches = [st["cache"] for st in states]
    for sh, dev, cache in zip(tp.shards, tp.devices, caches):
        if block_bitmap is not None:
            _with_block_bitmap(cache, _to_device(block_bitmap, dev), sh)
        if page_table is not None:
            _with_page_table(cache, _to_device(np.asarray(page_table, np.int32), dev), paged_impl)
    try:
        for _ in range(int(chunk)):
            row = tp.gather_logits([st["row"] for st in states])
            sample = _draw(sh0, st0, row, seeds, k_max, blocked)
            steps = [_write_sample(sh0, st, sample.to(dev)) for st, dev in zip(states, tp.devices)]
            new_rows = image_step_shards(tp, sample, [p for p, _ in steps], caches)
            for st, new_row, (img_pos, live) in zip(states, new_rows, steps):
                _advance(st, new_row, img_pos, live)
            host["img_pos"] += host["active"] & (host["img_pos"] < seq)
    finally:
        for cache in caches:
            _without_block_bitmap(cache)
            _without_page_table(cache)
    return state


def _draw(model: DALLE, state: dict, row: torch.Tensor, seeds, k_max: int, blocked) -> torch.Tensor:
    """One token per slot from the pending logits `row` [S, V]: each row's
    keep count and temperature, its noise keyed by (seed, image position)
    from the host mirrors. Returns codebook ids [S]."""
    masked = row.masked_fill(blocked, NEG_MASK_VALUE)
    filtered = top_k_filter_per_row(masked, state["keep_k"], k_max=k_max)
    positions = [int(p) for p in state["host"]["img_pos"]]
    noise = gumbel_noise(seeds, positions, model.total_tokens, row.device)
    return gumbel_sample_per_row(filtered, state["temps"], noise) - model.total_text_tokens


def _write_sample(model: DALLE, state: dict, sample: torch.Tensor):
    """Write live rows' samples at their image positions and stamp the
    cache index for the step. Returns (img_pos, live) before the step."""
    seq = model.image_seq_len
    img_pos = state["img_pos"]
    live = state["active"] & (img_pos < seq)
    col = img_pos.to(torch.long).clamp(0, seq - 1)[:, None]
    written = state["img_tokens"].scatter(1, col, sample[:, None].to(torch.int32))
    state["img_tokens"] = torch.where(live[:, None], written, state["img_tokens"])
    set_decode_cache_index(state["cache"], img_pos + model.text_seq_len + 1)
    return img_pos, live


def _advance(state: dict, new_row: torch.Tensor, img_pos: torch.Tensor, live: torch.Tensor) -> None:
    """Live rows take the step's logits and move one position on."""
    state["row"] = torch.where(live[:, None], new_row, state["row"])
    state["img_pos"] = torch.where(live, img_pos + 1, img_pos)


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
def init_paged_slot_state(model: DALLE, max_batch: int, n_pages: int, page_size: int, device=None) -> dict:
    """Empty paged decode state: `init_slot_state`'s per-slot control
    state, with K/V in pools of `n_pages` pages of `page_size` positions
    (page 0 is the serving layer's garbage page, never allocated), on the
    model's device or `device`."""
    device = model.text_emb.weight.device if device is None else device
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
        device=device,
        kv_dtype=model.kv_dtype,
    )
    return {"cache": cache, **_slot_control(model, max_batch, device)}


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


def _scatter_pages(pool_cache: dict, cache: dict, page_rows, page_size: int, partial_dst=None) -> None:
    """Scatter a wave's K/V (+ scales) into the page pools: row r's block j
    to page page_rows[r, j] ([R, n_blocks] host ints), and with
    `partial_dst` ([R]) its last block also to that page."""
    page_rows = np.asarray(page_rows, np.int64)
    device = next(iter(pool_cache.values()))["attn"]["k"].device
    pages = _to_device(page_rows.reshape(-1), device)
    snap = None if partial_dst is None else _to_device(np.asarray(partial_dst, np.int64), device)
    for name, layer in pool_cache.items():
        for key, pool in layer["attn"].items():
            if key == "index":
                continue
            blocks = _text_blocks(cache[name]["attn"][key], page_rows.shape[1], page_size)
            pool.index_copy_(0, pages, blocks.reshape(-1, *pool.shape[1:]).to(pool.dtype))
            if snap is not None:
                pool.index_copy_(0, snap, blocks[:, -1].to(pool.dtype))


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
    fmap, dim]}}} a later full-prompt hit restores; over shards (a placed
    `state`) {"shards": [one sidecar per shard]}, each its columns of the
    pending logits and its copy of the rings."""
    tp, states = _shards_of(model, state)
    caches = _wave_caches(tp, len(texts), block_bitmap)
    rows = prefill_shards(tp, _to_device(np.asarray(texts), tp.devices[0]), caches)
    sidecars = []
    for st, cache, row in zip(states, caches, rows):
        _scatter_pages(st["cache"], cache, page_rows, page_size, partial_dst)
        idx = _to_device(np.asarray(slots, np.int64), st["row"].device)
        rings = _extract_rings(cache)
        _admit_slot_rows(st, idx, slots, row, rings, seeds, temperatures, keep_ks)
        sidecars.append({"row": row.float(), "rings": rings})
    return {"shards": sidecars} if "shards" in state else sidecars[0]


@torch.inference_mode()
def resume_into_slots_paged(
    model: DALLE,
    state: dict,
    texts: np.ndarray,
    img_tokens: np.ndarray,
    img_pos: np.ndarray,
    slots: Sequence[int],
    seeds: Sequence[int],
    temperatures: Sequence[float],
    keep_ks: Sequence[int],
    page_rows: np.ndarray,
    page_size: int,
) -> dict:
    """`resume_into_slots`' teacher-forced re-prefill on a paged state,
    its K/V (+ scales) scattered into pages. `page_rows` [R,
    pages_per_row] names row r's page for each block: real pages up to the
    block covering its resume position, the garbage page (0) beyond, where
    the writes of the blocks past the prefix land as released rows' stale
    writes do (`ensure` maps real pages ahead of decode as usual). Resume
    rows share no prefix-cache page: the dispatch rewrites every page it
    maps (`PagedKVManager.admit_resume` gives fresh ones). Returns
    `state`."""
    tp, states = _shards_of(model, state)
    rows, caches = _resume_wave(tp, texts, img_tokens, img_pos)
    for st, cache, row in zip(states, caches, rows):
        _scatter_pages(st["cache"], cache, page_rows, page_size)
        idx = _to_device(np.asarray(slots, np.int64), st["row"].device)
        _admit_slot_rows(st, idx, slots, row, _extract_rings(cache), seeds, temperatures, keep_ks,
                         img_tokens=img_tokens, img_pos=img_pos)
    return state


def slice_prefix_sidecar(sidecar: dict, r: int) -> dict:
    """Row `r` of a wave's sidecar (each shard's, over shards), as tensors
    of its own (a cached entry does not keep the whole wave's alive)."""
    if "shards" in sidecar:
        return {"shards": [slice_prefix_sidecar(one, r) for one in sidecar["shards"]]}
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
    slot's sampling state (on each shard from its own sidecar). Returns
    `state`."""
    tp, states = _shards_of(model, state)
    for st, one in zip(states, shard_states(sidecar)):
        if (tp.shards[0].text_seq_len + 1) % page_size:
            for layer in st["cache"].values():
                for key, pool in layer["attn"].items():
                    if key != "index":
                        pool[int(partial_dst)].copy_(pool[int(partial_src)])
        idx = _to_device(np.asarray([slot], np.int64), st["row"].device)
        rings = {
            name: {key: t[None] for key, t in layer_rings.items()}
            for name, layer_rings in one["rings"].items()
        }
        _admit_slot_rows(st, idx, [slot], one["row"][None], rings, [seed], [temperature], [keep_k])
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
