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

Training over processes (`TrainingShards`, one tp shard a rank of a
`TrainMesh`; built by `training/steps.py:make_dalle_train_step`, which
hands it to `parallel/fsdp.py:FSDP` to cut after the initial broadcast):
the rank's DALLE is cut in place to heads / tp, FF hidden / tp and vocabulary / tp by
`parallel/partition.py:tp_placements` (whole units: q, k and v apart, the
GEGLU halves apart, whole heads; a parameter `_divisible` drops stays
whole and its layer runs whole), with any Adam moments cut alike, and the
split Linears and embeddings get a forward of their kind:

* column-parallel (`to_qkv`, `dense_0`): f (`parallel/collectives.py:
  copy_to_group`) on the input, then this shard's columns and bias;
* row-parallel (`to_out`, `dense_1`): this shard's product, then g
  (`reduce_from_group`: the sum over tp), then the bias, once;
* vocabulary-parallel embeddings: each rank looks up the ids in its row
  range, zeros elsewhere, then g (exact: one part is nonzero);
* the logits head: f, this shard's vocabulary columns, then the logits
  all-gathered over tp in vocabulary order (`gather_from_group`, whose
  backward keeps this shard's columns of the gradient). The loss then
  runs on the whole logits on every tp rank, as on one device: the
  gather costs [B, N, V] on each rank, no vocabulary-parallel
  cross-entropy. Where the DALLE reads the head's weights itself (tied
  embeddings, the fused loss: `DALLE._logits_kernel`) the shard installs
  its own `_logits_kernel` on the model, which reads them gathered over
  tp, the gradient again sliced.

Every tp rank holds the same rows and computes the same replicated
activations, so a replicated leaf's gradient is the same on every tp
rank (f sums the partial input gradients) and a split one's is its own:
nothing is summed over tp after the backward. Dropout draws per shard:
the masks of split hidden units are the shard's own draws, not a slice
of the one-device mask, and replicated masks agree across tp ranks
because every rank draws the same shapes from the same seed.
`whole(True)` puts the plain forwards, head counts and `_logits_kernel`
back (the full parameters in place: `FSDP.gathered`), `whole(False)` the
shard's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.parallel.collectives import (
    copy_to_group,
    gather_from_group,
    reduce_from_group,
)
from dalle_pytorch_tpu_torch.parallel.partition import (
    Placement,
    join_tensor,
    split_tensor,
    tp_placements,
)


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


class TrainingShards:
    """This rank's tp shard of a DALLE being trained over a `TrainMesh`
    with tp > 1 (module docstring). Built on the whole model, which it
    leaves whole: `cut(optimizer)` cuts the parameters (and the Adam
    moments `optimizer` already holds) in place and installs the split
    layers' forwards. `placements` maps each split parameter's name to its
    `Placement`; `split` maps id(parameter) to it."""

    def __init__(self, model, mesh):
        if any(getattr(m, "revnet", False) for m in model.modules()):
            raise ValueError("tp > 1 does not run the revnet executor, whose backward takes the "
                             "parameters themselves (ROADMAP.md Queue 1 item 8)")
        self.model, self.mesh = model, mesh
        self.comm, self.group = mesh.comm, mesh.group("tp")
        self.n, self.index = mesh.shape["tp"], mesh.coords["tp"]
        self.placements: Dict[str, Placement] = tp_placements(model, mesh)
        params = dict(model.named_parameters())
        self.split: Dict[int, Placement] = {id(params[k]): pl for k, pl in self.placements.items()}
        self._forwards: Dict[nn.Module, object] = {}
        self._heads: Dict[nn.Module, Tuple[int, int]] = {}
        self._plan()

    def cut(self, optimizer=None) -> None:
        """Cut the model (and `optimizer`'s Adam moments) into this rank's
        shard, in place, and run the shard's forwards."""
        params = dict(self.model.named_parameters())
        state = optimizer.adam.state if optimizer is not None else {}
        with torch.no_grad():
            for name, pl in self.placements.items():
                p = params[name]
                p.data = self.shard(p.data, pl)
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in state.get(p, {}):
                        state[p][key] = self.shard(state[p][key], pl)
        self.whole(False)

    def shard(self, t: torch.Tensor, placement: Placement) -> torch.Tensor:
        """This rank's shard of the whole tensor `t` (a contiguous copy)."""
        return split_tensor(t, placement, self.n)[self.index].contiguous()

    def full(self, t: torch.Tensor, placement: Placement) -> torch.Tensor:
        """The whole tensor of this rank's shard `t` (an all-gather over
        tp: a collective every tp rank runs)."""
        dim = placement.split_dim()
        parts = self.comm.all_gather(t.contiguous(), self.group, dim).chunk(self.n, dim)
        return join_tensor(parts, placement)

    def _split(self, name: str) -> bool:
        return name in self.placements

    def _plan(self) -> None:
        """The forward of each split module (`_forwards`) and the head
        counts of each split attention module (`_heads`)."""
        model, comm, group, n = self.model, self.comm, self.group, self.n
        for key, attn in model.transformer.attn.items():
            prefix = f"transformer.attn.{key}"
            if self._split(f"{prefix}.to_qkv.weight"):
                self._heads[attn] = (attn.heads, attn.heads // n)
                self._forwards[attn.to_qkv] = _column(attn.to_qkv, comm, group)
                self._forwards[attn.to_out] = _row(attn.to_out, comm, group)
        for key, ff in model.transformer.ff.items():
            if self._split(f"transformer.ff.{key}.dense_0.weight"):
                self._forwards[ff.dense_0] = _column(ff.dense_0, comm, group)
                self._forwards[ff.dense_1] = _row(ff.dense_1, comm, group)
        for name in ("text_emb", "image_emb"):
            if self._split(f"{name}.weight"):
                table = getattr(model, name)
                rows = table.num_embeddings // n
                self._forwards[table] = _vocab(table, self.index * rows, rows, comm, group)
        if not model.share_input_output_emb and self._split("logits_dense.weight"):
            self._forwards[model.logits_dense] = _column(model.logits_dense, comm, group,
                                                         gather_index=self.index)

    def _gathered(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """`t`, the value of parameter `name`, gathered over tp when it is
        split (the slice of the gradient backward)."""
        if not self._split(name):
            return t
        return gather_from_group(t, self.comm, self.group, self.index, 0)

    def _logits_kernel(self):
        """`DALLE._logits_kernel` on the shard: (kernel [D, V], bias [V] or
        None) of the whole logits head, its split weights gathered."""
        m = self.model
        if m.share_input_output_emb:
            kernel = torch.cat([self._gathered(m.text_emb.weight, "text_emb.weight"),
                                self._gathered(m.image_emb.weight, "image_emb.weight")], dim=0).t()
            return kernel, m.logits_bias
        return (self._gathered(m.logits_dense.weight, "logits_dense.weight").t(),
                self._gathered(m.logits_dense.bias, "logits_dense.bias"))

    def whole(self, on: bool) -> None:
        """The plain model's forwards, head counts and `_logits_kernel`
        (`on`), or the shard's."""
        for module, forward in self._forwards.items():
            if on:
                module.__dict__.pop("forward", None)
            else:
                module.forward = forward
        if on:
            self.model.__dict__.pop("_logits_kernel", None)
        else:
            self.model._logits_kernel = self._logits_kernel
        for attn, (whole, shard) in self._heads.items():
            attn.heads = whole if on else shard


def _column(lin: nn.Linear, comm, group, gather_index: Optional[int] = None):
    """A column-parallel Linear's forward: f, then this shard's columns;
    with `gather_index`, the outputs all-gathered along the last
    dimension (the logits head)."""

    def forward(x):
        y = F.linear(copy_to_group(x, comm, group), lin.weight, lin.bias)
        return y if gather_index is None else gather_from_group(y, comm, group, gather_index, -1)

    return forward


def _row(lin: nn.Linear, comm, group):
    """A row-parallel Linear's forward: this shard's product, g, then the
    bias once."""

    def forward(x):
        y = reduce_from_group(F.linear(x, lin.weight), comm, group)
        return y if lin.bias is None else y + lin.bias.to(y.dtype)

    return forward


def _vocab(table: nn.Embedding, start: int, rows: int, comm, group):
    """A vocabulary-parallel embedding's forward over rows [start, start +
    rows): the lookups in range, zeros elsewhere, then g."""

    def forward(ids):
        local = ids - start
        hit = (local >= 0) & (local < rows)
        vec = F.embedding(local.clamp(0, rows - 1), table.weight)
        vec = torch.where(hit[..., None], vec, torch.zeros((), dtype=vec.dtype, device=vec.device))
        return reduce_from_group(vec, comm, group)

    return forward
