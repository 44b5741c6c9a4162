"""Tensor parallelism by hand: what GSPMD inserts into the JAX package's
sharded programs, done here in one process over the shards of a mesh's
model axis.

* `shard_sum(parts, bias)` adds row-parallel partial results in shard
  order on shard 0's device, adds the bias once, and copies the sum back
  to every shard's device.
* `row_parallel` is a row-parallel Linear (`to_out`, FF `dense_1`) over
  the shards, `vocab_parallel_embed` a vocabulary-parallel lookup: each
  shard looks up the ids in its row range, writes zeros elsewhere, and
  the parts are summed (exactly: one part is nonzero).
* `TensorParallelDALLE` holds the shard modules of a DALLE: with a mesh,
  each shard a `DALLE` at heads / tp, FF hidden / tp and vocabulary / tp
  (each where `parallel/partition.py` splits it, else whole), loaded from
  `weights.py:shard_dalle_params`, on its own device; without one, the
  model itself as its one shard. Every cached decode op of the port runs
  over such a list of shards (`models/dalle.py`,
  `models/transformer.py:cached_forward`); with one shard each op is the
  plain model's arithmetic.

Copies between shards are plain `Tensor.to(device)`: the same code serves
shards on two cards and one card named twice. Shards run in order on each
device's current stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def shard_sum(parts: Sequence[torch.Tensor], bias: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """The sum of `parts` (one per shard), plus `bias` once, on every
    shard's device: summed in shard order on shard 0's device, then
    copied. One part (and no bias) is returned as it is."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    if bias is not None:
        total = total + bias.to(device=dev, dtype=total.dtype)
    return [total if p.device == dev else total.to(p.device) for p in parts]


def row_parallel(linears: Sequence[nn.Linear], xs: Sequence[torch.Tensor], split: bool) -> List[torch.Tensor]:
    """A row-parallel Linear over the shards: each shard's product of its
    input columns, summed by `shard_sum` with the bias added once. A layer
    that is not split (one shard, or replicated because the axis does not
    divide it) runs whole on every shard, bias included."""
    if not split:
        return [lin(x) for lin, x in zip(linears, xs)]
    parts = [F.linear(x, lin.weight) for lin, x in zip(linears, xs)]
    return shard_sum(parts, linears[0].bias)


def vocab_parallel_embed(
    tables: Sequence[nn.Embedding], starts: Sequence[int], ids: torch.Tensor, split: bool
) -> List[torch.Tensor]:
    """Embeddings of `ids` on every shard. Split: shard s holds rows
    [starts[s], starts[s] + rows) and looks up only those, zeros elsewhere;
    the parts are summed. Not split: every shard looks up all of them."""
    if not split:
        return [t(ids.to(t.weight.device)) for t in tables]
    parts = []
    for table, lo in zip(tables, starts):
        local = ids.to(table.weight.device) - lo
        hit = (local >= 0) & (local < table.num_embeddings)
        vec = table(local.clamp(0, table.num_embeddings - 1))
        parts.append(torch.where(hit[..., None], vec, torch.zeros((), dtype=vec.dtype, device=vec.device)))
    return shard_sum(parts)


def _ranges(total: int, n: int, split: bool) -> List[Tuple[int, int]]:
    """(start, rows) of each shard's piece of `total` rows."""
    if not split:
        return [(0, total)] * n
    step = total // n
    return [(s * step, step) for s in range(n)]


class TensorParallelDALLE:
    """The shards of one DALLE over the devices of a mesh's model axis.

    With `mesh`, `shards[s]` is a `DALLE` on `devices[s]` whose attention
    layers hold heads / tp (`Attention.row_parallel` set), whose FF layers
    hold hidden / tp (`FeedForward.row_parallel`), and whose `text_emb`,
    `image_emb` and logits head hold their vocabulary slice, each where the
    placement rules split it; norms, positional tables, LayerScale and the
    biases of row-parallel layers are whole on every shard. Without a mesh
    the one shard is `model` itself, nothing copied. Shard s's logits are
    the columns `head_segments[s]` ((global start, width) pairs) of the
    full row; `gather_logits` joins them in vocabulary order.
    """

    def __init__(self, model, mesh=None, model_axis: str = "tp"):
        self.mesh, self.model_axis = mesh, model_axis
        if mesh is None:
            self.devices = [model.text_emb.weight.device]
            self.tp = n = 1
            self.split_heads = self.split_text = self.split_image = self.split_logits = False
            self.split_ff = {key: False for key in model.transformer.ff}
        else:
            from dalle_pytorch_tpu_torch.parallel.partition import partition_params

            self.devices = [torch.device(d) for d in mesh.axis_devices(model_axis)]
            self.tp = n = len(self.devices)
            placements = partition_params(model, mesh)

            def split(name):
                return n > 1 and placements[name].split_dim(model_axis) is not None

            tr = model.transformer
            self.split_heads = split(f"transformer.attn.{next(iter(tr.attn))}.to_qkv.weight")
            self.split_ff = {key: split(f"transformer.ff.{key}.dense_0.weight") for key in tr.ff}
            self.split_text = split("text_emb.weight")
            self.split_image = split("image_emb.weight")
            self.split_logits = (self.split_text and self.split_image if model.share_input_output_emb
                                 else split("logits_dense.weight"))
            if model.share_input_output_emb and self.split_text != self.split_image:
                raise NotImplementedError(
                    "share_input_output_emb with only one of the text and image vocabularies "
                    "divisible by the model axis"
                )
        self.text_ranges = _ranges(model.total_text_tokens, n, self.split_text)
        self.image_ranges = _ranges(model.num_image_tokens, n, self.split_image)
        if model.share_input_output_emb:
            self.head_segments = [
                [text, (model.total_text_tokens + image[0], image[1])]
                for text, image in zip(self.text_ranges, self.image_ranges)
            ]
        else:
            self.head_segments = [[r] for r in _ranges(model.total_tokens, n, self.split_logits)]
        if mesh is None:
            self.shards = [model]
        else:
            from dalle_pytorch_tpu_torch.weights import shard_dalle_params

            params = shard_dalle_params(model, mesh, model_axis)
            self.shards = [self._build(model, params[s], s) for s in range(n)]

    @property
    def state_device(self):
        """Where a decode state is built before `place_state`: the model's
        device for one unsplit shard, else the host."""
        return None if self.mesh is None else "cpu"

    def place_state(self, state: dict) -> dict:
        """A whole decode state (built on `state_device`) as the shards'
        state {"shards": [one per shard], "host": the shared host mirrors}:
        each leaf split or copied by `parallel/serving_partition.py`'s rules,
        the pending logits split as the logits head is."""
        if self.mesh is None:
            return {"shards": [state], "host": state["host"]}
        from dalle_pytorch_tpu_torch.parallel.serving_partition import place_decode_state

        shards = place_decode_state(state, self.mesh, self.model_axis, split_row=self.split_logits)
        return {"shards": shards, "host": state["host"]}

    def _build(self, model, params: dict, s: int):
        from dalle_pytorch_tpu_torch.models.dalle import DALLE
        from dalle_pytorch_tpu_torch.models.transformer import FeedForward

        n = self.tp
        heads = model.heads // n if self.split_heads else model.heads
        kwargs = {**model.init_kwargs, "heads": heads, "kv_dtype": model.kv_dtype,
                  "decode_sparse_block": model.decode_sparse_block}
        with torch.device("meta"):
            shard = DALLE(**kwargs)
            for key, ff in shard.transformer.ff.items():
                full = model.transformer.ff[key]
                hidden = full.dense_1.in_features // n if self.split_ff[key] else full.dense_1.in_features
                shard.transformer.ff[key] = FeedForward(model.dim, dropout=full.dropout, hidden=hidden)
                shard.transformer.ff[key].row_parallel = self.split_ff[key]
            for attn in shard.transformer.attn.values():
                attn.row_parallel = self.split_heads
            if self.split_text:
                shard.text_emb = nn.Embedding(self.text_ranges[s][1], model.dim)
            if self.split_image:
                shard.image_emb = nn.Embedding(self.image_ranges[s][1], model.dim)
            width = sum(w for _, w in self.head_segments[s])
            if model.share_input_output_emb:
                shard.logits_bias = nn.Parameter(torch.empty(width))
            elif self.split_logits:
                shard.logits_dense = nn.Linear(model.dim, width)
        shard = shard.to(model.dtype).to_empty(device=self.devices[s]).eval()
        shard.requires_grad_(False)
        own = shard.state_dict()
        with torch.no_grad():
            for name, target in own.items():
                target.copy_(self._columns(name, params[name], target, s))
            full = dict(model.named_buffers())
            for name, buf in shard.named_buffers():
                buf.copy_(full[name])  # the rotary table and pattern masks
        return shard

    def _columns(self, name: str, value: torch.Tensor, target: torch.Tensor, s: int) -> torch.Tensor:
        """A replicated bias of a column-parallel layer at shard s's columns
        (the GEGLU halves' hidden units, the logits head's vocabulary)."""
        if value.shape == target.shape:
            return value
        if name.endswith(".dense_0.bias"):
            w = target.shape[0] // 2
            half = value.shape[0] // 2
            return torch.cat([value[s * w : (s + 1) * w], value[half + s * w : half + (s + 1) * w]])
        if name in ("logits_dense.bias", "logits_bias"):
            return torch.cat([value[lo : lo + w] for lo, w in self.head_segments[s]])
        raise ValueError(f"shard {s}: {name} of shape {tuple(value.shape)} does not fit {tuple(target.shape)}")

    def gather_logits(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards' logits columns joined in vocabulary order on shard 0's
        device (a replicated head: shard 0's row)."""
        if not self.split_logits:
            return parts[0]
        dev = parts[0].device
        pieces = []
        for part, segments in zip(parts, self.head_segments):
            at = 0
            for lo, w in segments:
                pieces.append((lo, part[..., at : at + w]))
                at += w
        return torch.cat([p.to(dev) for _, p in sorted(pieces, key=lambda lp: lp[0])], dim=-1)

    def embed(self, table: str, ids: torch.Tensor) -> List[torch.Tensor]:
        """`text_emb` or `image_emb` of `ids`, vocabulary-parallel, on every
        shard."""
        ranges, split = ((self.text_ranges, self.split_text) if table == "text_emb"
                         else (self.image_ranges, self.split_image))
        return vocab_parallel_embed([getattr(sh, table) for sh in self.shards],
                                    [lo for lo, _ in ranges], ids, split)
