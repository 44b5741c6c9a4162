"""GPipe pipeline parallelism over the `pp` axis of a training mesh: the
port's counterpart of the JAX package's `parallel/gpipe.py`
(`make_pp_mesh`, `stage_params_sharding`, `pipeline_layers`,
`gpipe_apply`).

One process a stage. Stage s of P holds the layers [s * L, (s + 1) * L)
of a depth-P * L stack (`stage_layers`, the counterpart of
`stage_params_sharding`'s split of the depth-stacked leaves; every rank
keeps the whole model, as the JAX pure-pp mesh keeps every parameter
replicated, and runs only its own layers). The schedule is GPipe's: M
microbatches flow through the P stages in M + P - 1 ticks; at tick t
stage s runs microbatch t - s when there is one, and at the end of the
tick every stage hands its output to the next (`StagePipe.shift`, one
`Collectives.pipe_shift` a tick: the JAX schedule's `ppermute`; the last
stage sends nothing forward and the first receives nothing). Per-
microbatch side inputs (`aux`, e.g. a key mask) ride the schedule: each
stage reads the slot of the microbatch it is running, as the JAX
`pipeline_layers` indexes `aux` at t - stage, with no extra hop. Dead
slots are skipped, where the JAX schedule runs them on zeros.

The backward is written by hand (`_GPipe.backward`): JAX differentiates
through the `ppermute`, and torch cannot differentiate through a send and
a receive. The forward keeps, for each microbatch a stage ran, its input
and the autograd graph of its layers; the backward runs the reverse
schedule, M + P - 1 ticks from the last stage to the first: stage s takes
dL/d(output) of microbatch m (the caller's gradient on the last stage,
else received from stage s + 1), backpropagates its layers through the
kept graph, and sends dL/d(input) to stage s - 1. The layers' parameters
are inputs of the function, so their gradients (summed over the
microbatches) land in `.grad` through autograd; a stage gives none for
the layers it does not hold.

`gpipe_apply` returns the trunk's output on every stage, as the JAX
`gpipe_apply` returns the last stage's outputs replicated (a broadcast
from the last stage), and the input's gradient on every stage (a
broadcast from the first), so every rank runs the embeddings, the head
and the loss on the same values and gets the same dL/d(output).
`reduce_stage_gradients` then sums each layer's gradient over pp (zero on
the stages that do not hold it): every rank ends the backward with the
same gradients and runs the same optimizer step on the same parameters.

A stage's pipe is anything with `stage`, `stages`, `shift(t, like,
reverse)` and `share(t, like, stage)`; `StagePipe` is the one over a
mesh's pp process group. With one stage `gpipe_apply` runs the layers in
order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh, make_train_mesh


def make_pp_mesh(pp: int, device="cpu") -> TrainMesh:
    """The pure-pp training mesh of this run's `pp` processes (every other
    axis 1): the JAX trainer's `MESH_AXES + ("pp",)` mesh, one process a
    stage."""
    return make_train_mesh(dp=1, pp=pp, device=device)


def stage_layers(depth: int, stages: int, stage: int) -> range:
    """The layers stage `stage` of `stages` holds: [stage * L, (stage + 1)
    * L) with L = depth / stages (`depth` must divide)."""
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by pp={stages}")
    per = depth // stages
    return range(stage * per, (stage + 1) * per)


class StagePipe:
    """The links of one stage over `mesh`'s pp process group."""

    def __init__(self, mesh: TrainMesh):
        self.comm, self.group = mesh.comm, mesh.group("pp")
        self.ranks = mesh.group_ranks("pp")
        self.stage, self.stages = mesh.coords["pp"], mesh.shape["pp"]
        # the group's first call made by every stage: under NCCL the first
        # batched point-to-point call of a group must include all its ranks,
        # and a schedule's first hop involves only stages 0 and 1
        self.comm.all_reduce(torch.zeros(1, device=mesh.device), self.group)

    def shift(self, t: Optional[torch.Tensor], like: Optional[torch.Tensor], reverse: bool = False):
        """The end of a tick: `t` (None: nothing to send) goes to the next
        stage (the previous one when `reverse`), and, when `like` is given,
        a tensor shaped as it comes from the previous (next) stage."""
        step = -1 if reverse else 1
        nxt, prev = self.stage + step, self.stage - step
        dst = self.ranks[nxt] if t is not None and 0 <= nxt < self.stages else None
        src = self.ranks[prev] if like is not None and 0 <= prev < self.stages else None
        return self.comm.pipe_shift(t, self.group, dst=dst, src=src, like=like)

    def share(self, t: Optional[torch.Tensor], like: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage `stage`'s tensor `t` on every stage (the others pass None
        and get a tensor shaped as `like`)."""
        buf = t.contiguous() if self.stage == stage else like.new_empty(like.shape)
        return self.comm.broadcast(buf, self.group, [self.ranks[stage]])


def _slot(t: torch.Tensor, n_micro: int):
    return list(t.chunk(n_micro)) if t is not None else [None] * n_micro


class _GPipe(torch.autograd.Function):
    """x [B, ...] -> the stack's output [B, ...] on every stage (module
    docstring); `params` are the stage's own layers' parameters."""

    @staticmethod
    def forward(ctx, x, pipe, run_stage, n_micro: int, aux, train: bool, *params):
        s, last = pipe.stage, pipe.stages - 1
        feeds, slots = _slot(x, n_micro), _slot(aux, n_micro)
        like = feeds[0]
        kept: List[Optional[tuple]] = [None] * n_micro
        outs: List[Optional[torch.Tensor]] = [None] * n_micro
        got = None
        for t in range(n_micro + last):
            m = t - s
            y = None
            if 0 <= m < n_micro:
                h = (feeds[m] if s == 0 else got).detach().requires_grad_(train)
                with torch.set_grad_enabled(train):
                    y = run_stage(h, slots[m])
                if y.shape != like.shape or y.dtype != like.dtype:
                    raise ValueError(f"a stage's output {tuple(y.shape)} {y.dtype} differs from its "
                                     f"input {tuple(like.shape)} {like.dtype}")
                kept[m] = (h, y) if train else None
                outs[m] = y.detach()
            # the next stage runs microbatch t + 1 - (s + 1) = m next tick
            got = pipe.shift(y if s < last else None, like if 0 <= m + 1 < n_micro and s > 0 else None)
        out = pipe.share(torch.cat(outs) if s == last else None, x, last)
        ctx.pipe, ctx.kept, ctx.n_micro = pipe, kept, n_micro
        ctx.params = params
        return out

    @staticmethod
    def backward(ctx, d_out):
        pipe, kept, n_micro, params = ctx.pipe, ctx.kept, ctx.n_micro, ctx.params
        s, last = pipe.stage, pipe.stages - 1
        r = last - s  # the stage's place in the reverse schedule
        douts = list(d_out.chunk(n_micro))
        like = douts[0]
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        dxs: List[Optional[torch.Tensor]] = [None] * n_micro
        got = None
        for t in range(n_micro + last):
            m = t - r
            dh = None
            if 0 <= m < n_micro:
                h, y = kept[m]
                dy = douts[m] if s == last else got
                res = torch.autograd.grad(y, (h, *params), dy, allow_unused=True)
                dh = res[0]
                for k, g in enumerate(res[1:]):
                    if g is not None:
                        grads[k] = g if grads[k] is None else grads[k] + g
                kept[m] = None
                dxs[m] = dh
            got = pipe.shift(dh if s > 0 else None, like if 0 <= m + 1 < n_micro and r > 0 else None,
                             reverse=True)
        dx = pipe.share(torch.cat(dxs) if s == 0 else None, d_out, 0)
        return (dx, None, None, None, None, None, *grads)


def pipeline_layers(pipe, layer_fn: Callable, layers: Sequence[int], x: torch.Tensor, n_micro: int,
                    aux: Optional[torch.Tensor] = None, params: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """This stage's program of the schedule (the JAX `pipeline_layers`):
    `layer_fn(i, h, aux_slot)` for each of the stage's `layers`, over the
    `n_micro` microbatches of `x` (and of `aux`, whose leading dimension is
    the batch's). `params` are the parameters those layers read (their
    gradients come back through autograd). Every stage calls it together;
    returns the stack's output on every stage."""
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} % n_micro {n_micro} != 0")

    def run_stage(h, aux_slot):
        for i in layers:
            h = layer_fn(i, h, aux_slot)
        return h

    train = torch.is_grad_enabled()
    return _GPipe.apply(x, pipe, run_stage, n_micro, aux, train, *params)


def gpipe_apply(pipe, layer_fn: Callable, depth: int, x: torch.Tensor, n_micro: int,
                aux: Optional[torch.Tensor] = None,
                layer_params: Optional[Callable[[int], Sequence[torch.Tensor]]] = None) -> torch.Tensor:
    """Run `depth` layers of `layer_fn(i, h, aux)` over `x` [batch, ...],
    pipelined over `pipe`'s stages (batch % n_micro == 0; `aux` a
    batch-leading side input). `layer_params(i)` names layer i's
    parameters (a tensor several layers share is taken once). Numerically
    the sequential stack; with one stage, it."""
    if pipe is None or pipe.stages == 1:
        for i in range(depth):
            x = layer_fn(i, x, aux)
        return x
    layers = stage_layers(depth, pipe.stages, pipe.stage)
    params = list({id(p): p for i in layers for p in (layer_params(i) if layer_params else ())}.values())
    return pipeline_layers(pipe, layer_fn, layers, x, n_micro, aux, params)


@torch.no_grad()
def reduce_stage_gradients(params: Sequence[torch.Tensor], mesh: TrainMesh) -> None:
    """Each of the stack's parameters' .grad summed over the pp ranks (a
    stage that does not hold a layer contributes zeros): one flat
    all-reduce a dtype."""
    group = mesh.group("pp")
    if group is None:
        return
    params = list(params)
    for dtype in sorted({p.dtype for p in params}, key=str):
        same = [p for p in params if p.dtype == dtype]
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in same])
        mesh.comm.all_reduce(flat, group)
        for p, part in zip(same, flat.split([p.numel() for p in same])):
            p.grad = part.view_as(p).clone()

