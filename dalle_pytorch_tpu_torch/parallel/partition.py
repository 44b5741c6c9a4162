"""Parameter partitioning rules: the port's parameter name -> a spec, the
counterpart of the JAX package's `parallel/partition.py` (`_RULES`,
`param_partition_spec`, `_divisible`).

A spec names, per dimension of the port's tensor, the mesh axis it is
split over or None, trailing Nones dropped (as a `PartitionSpec`). The
table is the JAX one in the port's layouts: a JAX Dense kernel [in, out]
is a torch `Linear.weight` [out, in], so each two-axis spec is reversed.

  to_qkv / FF dense_0 weight   [out, in] -> (tp, fsdp)   column parallel
  to_out / FF dense_1 weight   [out, in] -> (fsdp, tp)   row parallel
  text_emb / image_emb weight  [V, D]    -> (tp, fsdp)   vocab parallel
  logits_dense weight          [V, D]    -> (tp, fsdp)   vocab parallel
  text_pos_emb weight          [T, D]    -> (None, fsdp)
  any other Linear weight      [out, in] -> (None, fsdp)
  1-D and 3-D leaves (norms, biases, scales, the axial positions) replicated

Where a rule splits over tp, the split is made in whole units: `to_qkv`
is three parts (q, k, v) and `dense_0` two (the GEGLU value and gate
halves), each part split on its own, so a shard holds the same heads of q,
k and v and the same hidden units of both halves; `to_qkv` and `to_out`
split in whole heads (`dim_head` rows or columns). That is the one place
the port differs from the JAX table, whose GSPMD programs cut the joined
columns contiguously and reshard after the split. A replicated bias of a
column-parallel layer is read by each shard at its own columns
(`parallel/tensor_parallel.py`).

`_divisible` drops an axis whose size (times the parts and the unit) does
not divide the dimension: the parameter is then replicated, and its layer
runs whole on every shard.

Training (`state_shardings`' twin, `fsdp_dims` and `tp_dims`): a
parameter's fsdp dimension is the one its spec names "fsdp" and its tp
dimension the one it names "tp" (each after `_divisible` over the
training mesh's shape, on the whole tensor), and each of its Adam moments
follows it. A parameter is split over tp first, in whole units
(`split_tensor`), then its tp shard is cut into fsdp pieces (the JAX
`P("tp", "fsdp")` / `P("fsdp", "tp")`): rank i of the fsdp axis holds the
i-th of the axis's equal pieces of the fsdp dimension (`fsdp_shard`); the
all-gather over fsdp (`parallel/collectives.py`) joins them back in rank
order, and `join_tensor` joins the tp shards. In training the bias of a
column-parallel layer (the GEGLU's `dense_0`, the logits head) follows
its weight's split, so that a shard's gradient is its own; the JAX table
keeps 1-D leaves whole, and serving reads the whole bias at a shard's
columns (`parallel/tensor_parallel.py`).

The dVAE (`vae_fsdp_dims`): the JAX rule for a rank-4 conv kernel cuts
its output channels over fsdp (`P(None, None, None, "fsdp")`: dimension
0 of a torch `Conv2d` weight [O, I, kh, kw], dimension 1 of a
`ConvTranspose2d` weight [I, O, kh, kw]) and the codebook, an
`embedding`, its second dimension (`P("tp", "fsdp")`); biases stay whole.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from dalle_pytorch_tpu_torch.parallel.mesh import DeviceMesh

#: the axis tensor parallelism splits over (the JAX table's "tp")
MODEL_AXIS = "tp"
#: the axis fully sharded data parallelism splits parameters over
FSDP_AXIS = "fsdp"

Spec = Tuple[Optional[str], ...]

# (port name regex, rank of the tensor, spec, parts of the split dim,
# split in whole heads)
_RULES: Tuple[Tuple[str, int, Spec, int, bool], ...] = (
    (r"\.to_qkv\.weight$", 2, ("tp", "fsdp"), 3, True),
    (r"\.to_out\.weight$", 2, ("fsdp", "tp"), 1, True),
    (r"\.dense_0\.weight$", 2, ("tp", "fsdp"), 2, False),
    (r"\.dense_1\.weight$", 2, ("fsdp", "tp"), 1, False),
    (r"^logits_dense\.weight$", 2, ("tp", "fsdp"), 1, False),
    (r"^(text|image)_emb\.weight$", 2, ("tp", "fsdp"), 1, False),
    (r"^text_pos_emb\.weight$", 2, (None, "fsdp"), 1, False),
    (r"\.weight$", 2, (None, "fsdp"), 1, False),  # generic Linear fallback
)


class Placement(NamedTuple):
    """Where one tensor lives: its spec (after `_divisible`) and the parts
    of its split dimension, each split on its own."""

    spec: Spec
    parts: int = 1

    def split_dim(self, axis: str = MODEL_AXIS) -> Optional[int]:
        """The dimension split over `axis`, or None (replicated over it)."""
        for dim, axes in enumerate(self.spec):
            if axes == axis or (isinstance(axes, tuple) and axis in axes):
                return dim
        return None


def _strip(spec: Sequence) -> Spec:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def param_partition_spec(name: str, tensor: torch.Tensor) -> Tuple[Spec, int, bool]:
    """(spec, parts, whole heads) of one parameter, before `_divisible`."""
    for pattern, rank, spec, parts, heads in _RULES:
        if tensor.dim() == rank and re.search(pattern, name):
            return spec, parts, heads
    return (), 1, False


def _divisible(spec: Sequence, shape: Sequence[int], mesh: DeviceMesh, parts: int = 1,
               unit: int = 1) -> Spec:
    """Drop axis assignments that do not divide their dimension; the model
    axis's dimension must split into `parts` parts of whole `unit`s."""
    fixed = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            fixed.append(None)
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        size = math.prod(mesh.shape[a] for a in names)
        if MODEL_AXIS in names:
            size *= parts * unit
        fixed.append(axes if dim % size == 0 else None)
    return _strip(fixed)


def partition_params(model: torch.nn.Module, mesh) -> Dict[str, Placement]:
    """{parameter name: Placement} of a DALLE's parameters over `mesh` (a
    `DeviceMesh`, or anything with its `shape`: a `TrainMesh`)."""
    dim_head = model.dim_head
    out = {}
    for name, tensor in model.state_dict().items():
        spec, parts, heads = param_partition_spec(name, tensor)
        unit = dim_head if heads else 1
        out[name] = Placement(_divisible(spec, tensor.shape, mesh, parts, unit), parts)
    return out


def split_tensor(t: torch.Tensor, placement: Placement, n: int, axis: str = MODEL_AXIS) -> List[torch.Tensor]:
    """The `n` shards of `t` along `axis` (views): each of the placement's
    parts cut into n pieces, shard i taking piece i of every part. A
    tensor the axis does not split gives `t` itself to every shard."""
    dim = placement.split_dim(axis)
    if dim is None or n == 1:
        return [t] * n
    pieces = [part.chunk(n, dim) for part in t.chunk(placement.parts, dim)]
    return [torch.cat([p[i] for p in pieces], dim) if placement.parts > 1 else pieces[0][i]
            for i in range(n)]



def fsdp_dims(model: torch.nn.Module, mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension split over fsdp, or None (whole on
    every rank)} of a DALLE's parameters over a training mesh: the JAX
    `state_shardings`' rule, whose Adam moments take their parameter's."""
    names = dict(model.named_parameters())
    return {name: placement.split_dim(FSDP_AXIS)
            for name, placement in partition_params(model, mesh).items() if name in names}


def fsdp_shard(t: torch.Tensor, dim: Optional[int], index: int, n: int) -> torch.Tensor:
    """Rank `index`'s piece of `t` along `dim` (a contiguous copy), of `n`
    equal pieces; `t` itself when `dim` is None."""
    if dim is None or n == 1:
        return t
    return t.chunk(n, dim)[index].contiguous()


#: the column-parallel biases that follow their weight's tp split in training
_BIAS_FOLLOWS = {r"\.dense_0\.bias$": ".dense_0.weight", r"^logits_dense\.bias$": "logits_dense.weight"}


def tp_placements(model: torch.nn.Module, mesh) -> Dict[str, Placement]:
    """{parameter name: Placement} of a DALLE's parameters split over tp
    on a training mesh (the others are whole on every tp rank), computed on
    the whole tensors: `partition_params`' placements whose spec names tp,
    and the column-parallel biases beside their weights."""
    placements = partition_params(model, mesh)
    out = {}
    for name, _ in model.named_parameters():
        source = name
        for pattern, weight in _BIAS_FOLLOWS.items():
            source = re.sub(pattern, weight, source)
        placement = placements.get(source)
        if placement is None or placement.split_dim(MODEL_AXIS) is None:
            continue
        out[name] = Placement((MODEL_AXIS,), placement.parts) if source != name else placement
    return out


def tp_dims(model: torch.nn.Module, mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension split over tp, or None (whole on
    every tp rank)} of a DALLE's parameters over a training mesh
    (`tp_placements`), the counterpart of `fsdp_dims`."""
    split = tp_placements(model, mesh)
    return {name: split[name].split_dim(MODEL_AXIS) if name in split else None
            for name, _ in model.named_parameters()}


def join_tensor(shards: Sequence[torch.Tensor], placement: Placement, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The inverse of `split_tensor`: the whole tensor from its shards in
    shard order, each of the placement's parts joined on its own."""
    dim = placement.split_dim(axis)
    if dim is None or len(shards) == 1:
        return shards[0]
    if placement.parts == 1:
        return torch.cat(list(shards), dim)
    pieces = [s.chunk(placement.parts, dim) for s in shards]
    return torch.cat([torch.cat([p[j] for p in pieces], dim) for j in range(placement.parts)], dim)


def vae_fsdp_dims(vae: torch.nn.Module, mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension split over fsdp, or None} of a
    DiscreteVAE's parameters over a training mesh: conv kernels by their
    output channels, the codebook by its channels, where fsdp divides."""
    n = mesh.shape[FSDP_AXIS]
    modules = dict(vae.named_modules())
    out = {}
    for name, p in vae.named_parameters():
        owner = modules[name.rpartition(".")[0]]
        dim = None
        if name.endswith(".weight") and p.dim() == 4:
            dim = 1 if isinstance(owner, torch.nn.ConvTranspose2d) else 0
        elif name.endswith(".weight") and isinstance(owner, torch.nn.Embedding):
            dim = 1
        out[name] = dim if dim is not None and n > 1 and p.shape[dim] % n == 0 else None
    return out
