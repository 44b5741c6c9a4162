"""Data-parallel and fully sharded (fsdp) training over a `TrainMesh`, by
hand over the port's partition table: what GSPMD makes of the JAX
trainer's `state_shardings` and batch sharding.

At rest each rank holds its fsdp piece of every parameter that
`parallel/partition.py:fsdp_dims` splits (the JAX `_RULES`' "fsdp"
dimension, dropped by `_divisible` where it does not divide), and the
Adam moments of that parameter are pieces of the same shape (the
optimizer runs over the pieces). Leaves the table leaves whole (norms,
biases, scales, the axial positions) are whole on every rank.

* Forward: a module's pieces are all-gathered just before its forward
  (a forward pre-hook) and dropped just after it (a forward hook). The
  gathered tensor stands in for the parameter as an attribute of the
  module, so the module's own code reads it. Under autocast a Linear's
  weight is gathered already in the autocast type, the type autocast
  would cast it to; embeddings stay in float32. Parameters the DALLE reads
  outside their module's forward (`DALLE.weights_read_outside_modules`)
  are gathered around the whole DALLE forward instead.
* The full weights are not kept for the backward: a saved-tensor hook
  (`saving()`, around the forward) recognises a tensor saved for the
  backward that is one of them (or a view of one) and keeps a note in its
  place; the backward gathers it again when it unpacks the note.
* Backward: the gradient of a gathered weight is reduce-scattered over
  fsdp onto its piece (`_Gather`'s backward). After the backward,
  `reduce_gradients` sums the pieces' gradients over dp and the whole
  leaves' over dp x fsdp (one flat all-reduce each) and divides by the
  number of data ranks: the mean over the global batch.
* The global gradient norm (`grad_norm`) sums the squared norms of the
  pieces over fsdp and adds the whole leaves' once (not fsdp times).
* `gathered(optimizer)` puts full parameters (and full Adam moments) in
  place of the pieces for exports, checkpoints and the in-loop sample: a
  collective every rank runs.

At fsdp = 1 nothing is split and the object only averages gradients over
the data ranks (plain data parallelism). Initial parameters are broadcast
from rank 0 at construction, so every rank starts from the same ones.

Over tp > 1 the caller hands in the model's tp shard
(`parallel/tensor_parallel.py:TrainingShards`, built on the whole model),
which is cut after the broadcast, and fsdp then cuts each tp shard into
its pieces (the JAX `P("tp", "fsdp")`): the fsdp dimensions are taken on
the whole tensors before the tp cut.
Gradients are never summed over sp or tp: the sequence-parallel ranks
compute the same gradients (`models/attention.py`), a tp shard's gradient
is its own, and a leaf tp keeps whole has the same gradient on every tp
rank (Megatron's f sums the partial input gradients). The global norm
adds each tp shard's squares once (a sum over tp), and `gathered()` joins
the tp shards after the fsdp pieces, so exports and Adam state are whole
tensors whatever the mesh.

The dVAE's data mesh takes the same object with its own fsdp dimensions
(`dims=parallel/partition.py:vae_fsdp_dims`); it has no tp split.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh
from dalle_pytorch_tpu_torch.parallel.partition import fsdp_dims, fsdp_shard

#: the Adam state entries shaped as their parameter
MOMENTS = ("exp_avg", "exp_avg_sq")


class _Entry:
    """One fsdp-split parameter: its piece (`param`), split dimension, the
    module holding it as `attr`, and whether it is a Linear's weight."""

    def __init__(self, param: nn.Parameter, dim: int, owner: nn.Module, attr: str):
        self.param, self.dim, self.owner, self.attr = param, dim, owner, attr
        self.linear = isinstance(owner, nn.Linear)


class _Regather:
    """A full weight saved for the backward, kept as a note: its entry,
    type and view geometry."""

    def __init__(self, entry: _Entry, dtype: torch.dtype, t: torch.Tensor):
        self.entry, self.dtype = entry, dtype
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class _Gather(torch.autograd.Function):
    """The full weight of a piece (an all-gather over fsdp); its backward
    reduce-scatters the weight's gradient onto the piece."""

    @staticmethod
    def forward(ctx, piece, fsdp, entry, dtype):
        ctx.fsdp, ctx.entry = fsdp, entry
        return fsdp.gather(entry, piece, dtype)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fsdp.scatter(ctx.entry, grad), None, None, None


class FSDP:
    """The data-parallel state of a model on one rank of `mesh`: cuts it
    into its tp shard `tp` (a `TrainingShards`, where tp > 1), splits its
    parameters (and any Adam state `optimizer` already holds) over fsdp,
    in place, and installs the gathering hooks. `dims` ({parameter name:
    fsdp dimension or None}) defaults to the DALLE's `fsdp_dims`."""

    def __init__(self, model: nn.Module, mesh: TrainMesh, optimizer=None,
                 dims: Optional[Dict[str, Optional[int]]] = None, tp=None):
        if any(getattr(m, "revnet", False) for m in model.modules()) and mesh.shape["fsdp"] > 1:
            raise ValueError("fsdp > 1 does not run the revnet executor, whose backward takes the "
                             "parameters themselves (ROADMAP.md Queue 1 item 8)")
        if (tp is not None) != (mesh.shape["tp"] > 1):
            raise ValueError(f"a mesh of tp = {mesh.shape['tp']} takes its TrainingShards, got {tp}")
        self.model, self.mesh, self.comm = model, mesh, mesh.comm
        self.group = mesh.group("fsdp")
        self.n, self.index = mesh.shape["fsdp"], mesh.coords["fsdp"]
        self._whole = False  # full parameters in place (`gathered`): hooks idle
        self._live: Dict[int, tuple] = {}  # storage pointer of a gathered weight -> (entry, dtype)
        self._broadcast_initial()
        if dims is None:
            dims = fsdp_dims(model, mesh) if self.n > 1 else {}
        # the tp cut, after the fsdp dimensions are read off the whole tensors
        self.tp = tp
        if tp is not None:
            tp.cut(optimizer)
        self._tp_split = tp.split if tp is not None else {}
        modules = dict(model.named_modules())
        outside = set(model.weights_read_outside_modules())
        self.entries: List[_Entry] = []
        by_user: Dict[nn.Module, List[_Entry]] = {}
        for name, p in model.named_parameters():
            if dims.get(name) is None:
                continue
            owner_name, _, attr = name.rpartition(".")
            entry = _Entry(p, dims[name], modules[owner_name], attr)
            with torch.no_grad():
                p.data = fsdp_shard(p.data, entry.dim, self.index, self.n)
                state = optimizer.adam.state.get(p, {}) if optimizer is not None else {}
                for key in MOMENTS:
                    if key in state:
                        state[key] = fsdp_shard(state[key], entry.dim, self.index, self.n)
            self.entries.append(entry)
            by_user.setdefault(model if name in outside else entry.owner, []).append(entry)
        self._split = {id(e.param) for e in self.entries}
        self._entry_of = {id(e.param): e for e in self.entries}
        for user, entries in by_user.items():
            user.register_forward_pre_hook(lambda module, args, es=entries: self._gather_for(es))
            user.register_forward_hook(lambda module, args, out, es=entries: self._drop(es))
        model._fsdp = self

    # --- communication ---------------------------------------------------

    def _broadcast_initial(self) -> None:
        """Rank 0's parameters on every rank (one flat broadcast a type)."""
        if self.mesh.world == 1:
            return
        params = [p.data for p in self.model.parameters()]
        for dtype in sorted({p.dtype for p in params}, key=str):
            same = [p for p in params if p.dtype == dtype]
            flat = torch.cat([p.reshape(-1) for p in same])
            self.comm.broadcast(flat, dist.group.WORLD, [0])
            for p, part in zip(same, flat.split([p.numel() for p in same])):
                p.copy_(part.view_as(p))

    def gather(self, entry: _Entry, piece: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The full tensor of `piece`s over fsdp, in `dtype`."""
        return self.comm.all_gather(piece.detach().to(dtype), self.group, entry.dim)

    def scatter(self, entry: _Entry, grad: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the sum over fsdp of a full gradient."""
        return self.comm.reduce_scatter(grad.to(entry.param.dtype), self.group, entry.dim)

    # --- hooks -----------------------------------------------------------

    def _gather_for(self, entries: List[_Entry]) -> None:
        if self._whole:
            return
        for e in entries:
            dtype = e.param.dtype
            device_type = e.param.device.type
            if e.linear and torch.is_autocast_enabled(device_type):
                dtype = torch.get_autocast_dtype(device_type)
            full = _Gather.apply(e.param, self, e, dtype)
            e.owner.__dict__[e.attr] = full  # found before the module's _parameters
            self._live[full.untyped_storage().data_ptr()] = (e, dtype)

    def _drop(self, entries: List[_Entry]) -> None:
        for e in entries:
            full = e.owner.__dict__.pop(e.attr, None)
            if full is not None:
                self._live.pop(full.untyped_storage().data_ptr(), None)

    def _pack(self, t: torch.Tensor):
        if self._live and t.layout == torch.strided:
            hit = self._live.get(t.untyped_storage().data_ptr())
            if hit is not None:
                return _Regather(hit[0], hit[1], t)
        return t

    def _unpack(self, saved):
        if isinstance(saved, _Regather):
            full = self.gather(saved.entry, saved.entry.param, saved.dtype)
            return full.as_strided(saved.size, saved.stride, saved.offset)
        return saved

    def saving(self):
        """The saved-tensor hooks to run a forward under: full weights
        saved for the backward are gathered again there, not kept."""
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    # --- after the backward ----------------------------------------------

    def _all_reduce_flat(self, tensors: List[torch.Tensor], group) -> None:
        if group is None or not tensors:
            return
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            same = [t for t in tensors if t.dtype == dtype]
            flat = self.comm.all_reduce(torch.cat([t.reshape(-1) for t in same]), group)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Each parameter's .grad becomes the mean over the global batch:
        the pieces' summed over dp (fsdp was summed by the reduce-scatter),
        the whole leaves' over dp x fsdp, both divided by the data ranks."""
        if self.mesh.data_world == 1:
            return
        grads = [p for p in self.model.parameters() if p.grad is not None]
        split = [p.grad for p in grads if id(p) in self._split]
        whole = [p.grad for p in grads if id(p) not in self._split]
        self._all_reduce_flat(split, self.mesh.group("dp"))
        self._all_reduce_flat(whole, self.mesh.group("dp", "fsdp"))
        for g in split + whole:
            g.div_(self.mesh.data_world)

    @torch.no_grad()
    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global 2-norm of the gradients `grads` (this rank's .grad
        tensors): the squares of fsdp pieces summed over fsdp, those of tp
        shards over tp (a piece of a tp shard over both), the whole leaves'
        counted once."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        fsdp_ids = {id(p.grad) for p in params if id(p) in self._split}
        tp_ids = {id(p.grad) for p in params if id(p) in self._tp_split}
        # the squares by (split over fsdp, split over tp): [fsdp only, both, tp only, whole]
        slot = {(True, False): 0, (True, True): 1, (False, True): 2, (False, False): 3}
        sq = torch.zeros(4, dtype=torch.float32, device=grads[0].device)
        for g in grads:
            sq[slot[id(g) in fsdp_ids, id(g) in tp_ids]] += g.float().pow(2).sum()
        sq[:2] = self.comm.all_reduce(sq[:2].clone(), self.group)
        if self.tp is not None:
            sq[1:3] = self.comm.all_reduce(sq[1:3].clone(), self.tp.group)
        return sq.sum().sqrt()

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Step metrics (this rank's means) as means over the data ranks."""
        group = self.mesh.group("dp", "fsdp")
        if group is None or not metrics:
            return metrics
        keys = sorted(metrics)
        vec = self.comm.all_reduce(torch.stack([metrics[k].float().reshape(()) for k in keys]), group)
        return dict(zip(keys, vec / self.mesh.data_world))

    # --- full state --------------------------------------------------------

    def full(self, param: nn.Parameter, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of `t`, this rank's piece of `param` or of one
        of its moments or its gradient: the fsdp pieces joined, then the tp
        shards (collectives every rank of those axes runs)."""
        entry = self._entry_of.get(id(param))
        if entry is not None:
            t = self.gather(entry, t, t.dtype)
        placement = self._tp_split.get(id(param))
        return t if placement is None else self.tp.full(t, placement)

    @contextmanager
    def gathered(self, optimizer=None):
        """Full parameters (and, with `optimizer`, full Adam moments) in
        place of the pieces and tp shards inside the block, the plain
        model's forwards in place of the shard's; a collective on every
        rank."""
        kept = []
        self._whole = True
        try:
            with torch.no_grad():
                for p in self.model.parameters():
                    if id(p) not in self._split and id(p) not in self._tp_split:
                        continue
                    piece = p.data
                    state = optimizer.adam.state.get(p, {}) if optimizer is not None else {}
                    moments = {k: state[k] for k in MOMENTS if k in state}
                    kept.append((p, piece, state, moments))
                    p.data = self.full(p, piece)
                    for k, m in moments.items():
                        state[k] = self.full(p, m)
            if self.tp is not None:
                self.tp.whole(True)
            yield
        finally:
            for p, piece, state, moments in kept:
                p.data = piece
                state.update(moments)
            if self.tp is not None:
                self.tp.whole(False)
            self._whole = False


def fsdp_of(model: nn.Module) -> Optional[FSDP]:
    """The `FSDP` a model was split by, or None."""
    return model.__dict__.get("_fsdp")


def gathered(model: nn.Module, optimizer=None):
    """Full parameters (and Adam moments) of a model split by `FSDP` inside
    the block (a collective: every rank enters it); nothing for another
    model."""
    fsdp = fsdp_of(model)
    return fsdp.gathered(optimizer) if fsdp is not None else nullcontext()
