"""The collectives of multi-process training: what XLA inserts into the
JAX package's sharded programs, written out over `torch.distributed`.

* `all_reduce` sums a tensor over a group (gradient averaging over the
  data ranks, the loss and the global gradient norm);
* `all_gather` joins the group's tensors along a dimension (an fsdp
  parameter's full value, the ring's outputs over sp);
* `reduce_scatter` sums over the group and keeps this member's piece
  along a dimension (an fsdp parameter's gradient);
* `broadcast` copies the group's first member's tensor to the others
  (the initial parameters);
* `pipe_shift` sends a tensor to one rank and receives one from another,
  either side optional, posted together (`dist.batch_isend_irecv`): one
  hop of a pipeline (`parallel/gpipe.py`, the JAX schedule's non-cyclic
  `ppermute`), where the last stage sends nothing forward and the first
  receives nothing;
* `ring_shift` is `pipe_shift` to the next member of the group and from
  the previous one, one hop of the ring (`parallel/ring.py`, the JAX
  ring's `ppermute`), counted under its own name.

Gloo does not send or receive CUDA tensors (`batch_isend_irecv` fails in
the transport; `scripts/torch_collectives_probe.py` on the card, torch
2.11: Gloo takes CUDA tensors in the other four calls). So under Gloo a
CUDA tensor's `ring_shift` and `pipe_shift` are staged through host
memory, and only those calls: `STAGED` names the staged calls of each
backend, selected by the backend's name and never by a caught error.
Every staged call is counted in `staged`; under NCCL nothing is staged.
A group of None (an axis of one rank) makes every call the identity.

Tensor parallelism's two autograd-aware calls (Megatron's f and g) wrap
`all_reduce`: `copy_to_group` (f) is the identity forward and sums the
gradient over the group backward, at the input of a column-parallel
layer; `reduce_from_group` (g) sums over the group forward (in float32,
rounded once to the input's type) and passes the gradient through
backward, at the output of a row-parallel layer. `gather_from_group`
all-gathers along a dimension and keeps this member's slice of the
gradient backward (the vocabulary-parallel logits, whose consumers run
the same on every member).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: the calls each backend runs on host copies of CUDA tensors
STAGED = {"gloo": frozenset({"ring_shift", "pipe_shift"}), "nccl": frozenset()}


class Collectives:
    """The collectives of one rank on `device` under `backend` (None: no
    process group, one rank)."""

    def __init__(self, backend: Optional[str], device):
        self.backend = backend
        self.device = torch.device(device)
        self._staged_calls = STAGED.get(backend, frozenset()) if self.device.type == "cuda" else frozenset()
        #: calls made, the bytes this rank put into them, and the calls
        #: staged through host memory, by name
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.staged: Counter = Counter()

    def _stage(self, name: str, t: torch.Tensor, sent: bool = True) -> torch.Tensor:
        """Count a call of `name` on `t`: with `sent`, the tensor this rank
        puts in (its bytes counted), returned as a host copy where the
        backend stages the call; else the shape and type of a tensor to
        receive, returned as an empty buffer (on the host where staged)."""
        self.calls[name] += 1
        if sent:
            self.bytes[name] += t.numel() * t.element_size()
        if name in self._staged_calls and t.is_cuda:
            self.staged[name] += 1
            return t.cpu() if sent else torch.empty(t.shape, dtype=t.dtype)
        return t if sent else torch.empty_like(t)

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """The sum of `t` over `group`, in place; returns `t`."""
        if group is None:
            return t
        work = self._stage("all_reduce", t)
        dist.all_reduce(work, group=group)
        if work is not t:
            t.copy_(work)
        return t

    def all_gather(self, t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
        """The group's tensors (each shaped as `t`) joined along `dim`, in
        group order."""
        if group is None:
            return t
        work = self._stage("all_gather", t.contiguous())
        parts = [torch.empty_like(work) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, work, group=group)
        return torch.cat(parts, dim).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
        """This member's piece along `dim` of the sum of `t` over `group`
        (`dim` divides into the group's size)."""
        if group is None:
            return t
        n = dist.get_world_size(group)
        work = self._stage("reduce_scatter", t)
        pieces = [p.contiguous() for p in work.chunk(n, dim)]
        out = torch.empty_like(pieces[0])
        dist.reduce_scatter(out, pieces, group=group)
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor, group, ranks: Sequence[int]) -> torch.Tensor:
        """`t` of the group's first member (global rank `ranks[0]`) on
        every member, in place."""
        if group is None:
            return t
        work = self._stage("broadcast", t)
        dist.broadcast(work, src=ranks[0], group=group)
        if work is not t:
            t.copy_(work)
        return t

    def ring_shift(self, t: torch.Tensor, group, ranks: Sequence[int], index: int) -> torch.Tensor:
        """One hop of the ring: `t` goes to the next member (`ranks[index +
        1]`, cyclically) and the previous member's tensor comes back."""
        if group is None:
            return t
        n = len(ranks)
        return self.pipe_shift(t, group, ranks[(index + 1) % n], ranks[(index - 1) % n], like=t,
                               name="ring_shift")

    def pipe_shift(self, t: Optional[torch.Tensor], group, dst: Optional[int] = None,
                   src: Optional[int] = None, like: Optional[torch.Tensor] = None,
                   name: str = "pipe_shift") -> Optional[torch.Tensor]:
        """One hop of a pipeline: `t` goes to global rank `dst` (when both
        are given) and a tensor shaped and typed as `like` comes back from
        global rank `src` (when given), the two posted together. Returns
        the received tensor on `like`'s device, or None. One call of
        `name`, counted on the tensor sent, else on the one received."""
        send = t is not None and dst is not None
        if group is None or not (send or src is not None):
            return None
        ops: List[dist.P2POp] = []
        got = None
        if send:
            work = self._stage(name, t.contiguous())
            ops.append(dist.P2POp(dist.isend, work, dst, group))
            if src is not None:
                got = torch.empty(like.shape, dtype=like.dtype, device=work.device)
        elif src is not None:
            got = self._stage(name, like, sent=False)
        if got is not None:
            ops.append(dist.P2POp(dist.irecv, got, src, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if got is None else got.to(like.device)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward; the gradient summed over the
    group backward."""

    @staticmethod
    def forward(ctx, x, comm, group):
        ctx.comm, ctx.group = comm, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.contiguous().clone(), ctx.group), None, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the sum over the group forward (in float32, rounded
    once to the input's type); the gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, comm, group):
        total = comm.all_reduce(x.float().contiguous().clone(), group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFromGroup(torch.autograd.Function):
    """The group's tensors joined along `dim` forward; this member's slice
    of the gradient backward (every member's consumer computed the same
    gradient of the whole)."""

    @staticmethod
    def forward(ctx, x, comm, group, index: int, dim: int):
        ctx.index, ctx.dim, ctx.n = index, dim, dist.get_world_size(group)
        return comm.all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.index].contiguous(), None, None, None, None


def copy_to_group(x: torch.Tensor, comm: Collectives, group) -> torch.Tensor:
    """f (`_CopyToGroup`); `x` itself for a group of None."""
    return x if group is None else _CopyToGroup.apply(x, comm, group)


def reduce_from_group(x: torch.Tensor, comm: Collectives, group) -> torch.Tensor:
    """g (`_ReduceFromGroup`); `x` itself for a group of None."""
    return x if group is None else _ReduceFromGroup.apply(x, comm, group)


def gather_from_group(x: torch.Tensor, comm: Collectives, group, index: int, dim: int) -> torch.Tensor:
    """`x` of every member joined along `dim` in group order, member
    `index`'s slice of the gradient backward; `x` for a group of None."""
    return x if group is None else _GatherFromGroup.apply(x, comm, group, index, dim)
