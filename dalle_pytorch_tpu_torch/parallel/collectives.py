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
* `ring_shift` sends a tensor to the next member of the group and
  receives the previous member's (`dist.batch_isend_irecv`), one hop of
  the ring (`parallel/ring.py`, the JAX ring's `ppermute`).

Gloo does not send or receive CUDA tensors (`batch_isend_irecv` fails in
the transport; `scripts/torch_collectives_probe.py` on the card, torch
2.11: Gloo takes CUDA tensors in the other four calls). So under Gloo a
CUDA tensor's `ring_shift` is staged through host memory, and only that
call: `STAGED` names the staged calls of each backend, selected by the
backend's name and never by a caught error. Every staged call is
counted in `staged`; under NCCL nothing is staged. A group of None (an
axis of one rank) makes every call the identity.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: the calls each backend runs on host copies of CUDA tensors
STAGED = {"gloo": frozenset({"ring_shift"}), "nccl": frozenset()}


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

    def _stage(self, name: str, t: torch.Tensor) -> torch.Tensor:
        self.calls[name] += 1
        self.bytes[name] += t.numel() * t.element_size()
        if name in self._staged_calls and t.is_cuda:
            self.staged[name] += 1
            return t.cpu()
        return t

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
        work = self._stage("ring_shift", t.contiguous())
        got = torch.empty_like(work)
        ops: List[dist.P2POp] = [
            dist.P2POp(dist.isend, work, ranks[(index + 1) % n], group),
            dist.P2POp(dist.irecv, got, ranks[(index - 1) % n], group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got.to(t.device)
