"""The DALLE, dVAE and CLIP training steps: loss, gradients and the Adam
update.

Counterpart of the JAX package's `training/steps.py` (`make_optimizer`,
`get_learning_rate` / `set_learning_rate`, `make_dalle_train_step` with
its `_accumulate` / `_microbatch` and the in-step dVAE encode,
`make_vae_train_step`, `make_clip_train_step`, `make_multi_step`,
`window_keys`, `stack_batches`, `window_iter`). A
batch is {"text": [B, T] ids, "image_tokens": [B, N] ids}, or with a
frozen `vae` {"text", "images": [B, H, W, C] in [0, 1]}: the step then
encodes the images to tokens first, without gradient, in the VAE's
float32 and outside autocast. The pipeline-parallel trunk is not ported.

Objective modes (`MODES`): forward_only is the text -> image loss;
forward_forward adds the inverse (image -> text) loss in the same layer
order and forward_reverse_partial in reversed layer order; reverse_only
is the inverse loss alone. Both objectives of a step share one
null-conditioning draw, as the reference's share one rng. `grad_accum`
splits the batch into that many microbatches and averages their
gradients and metrics.

The optimizer is optax's chain of `clip_by_global_norm` and `adam`
(b1 0.9, b2 0.999, eps 1e-8): the clip scales every gradient by
c / max(||g||, c) over the global norm, with no epsilon (not
`clip_grad_norm_`'s c / (||g|| + 1e-6)), and the Adam update is
torch's, the same formula. The learning rate is mutable and held at
float32 precision, as optax's injected hyperparameter is, so that it
survives a checkpoint's float32 leaf exactly.

`steps_per_dispatch` (`make_multi_step`): a window of T batches runs as T
steps in turn and reports their mean metrics; each step takes its own
key from `window_keys`, a pure function of (seed, global step), so a
window, an epoch tail and a resumed run all draw what an uninterrupted
one-step-at-a-time run draws. The window's batches stay separate: with
no capture of the window as one CUDA graph (not done yet) there is
nothing to gain from one copy, and `stack_batches` is the layout such a
capture would take.

Over a training mesh (`make_dalle_train_step(..., mesh=)`, a `TrainMesh`
of more than one rank) each data rank (a dp x fsdp coordinate) steps on
its own rows: the global batch is the data ranks' rows in `data_rank`
order (the batch the JAX `put_host_batch` assembles), and
`parallel/fsdp.py:FSDP` splits the parameters over fsdp, averages the gradients over dp x fsdp,
takes the global gradient norm and averages the metrics. The
null-conditioning draw is made for the global microbatch from the step's
key and sliced by rank, so with `grad_accum` = 1 a row draws what it
draws on one device (microbatch i of the global step is each data rank's
microbatch i in rank order). The sp ranks of a data coordinate hold the
same rows and compute the same step.

Mixed precision: the reference keeps float32 parameters and computes in
bfloat16 through flax's `dtype`, which also makes its residual stream
bfloat16. Here `autocast_dtype=torch.bfloat16` runs the step under
`torch.autocast` over float32 parameters: matrix products and the
attention kernels take bfloat16 inputs, but the residual stream,
LayerNorm statistics and the loss stay float32. So the two round at
different places; losses agree closely, not bitwise.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dalle_pytorch_tpu_torch.ops.sampling import row_seed
from dalle_pytorch_tpu_torch.parallel.fsdp import FSDP, fsdp_of

MODES = ("forward_only", "forward_forward", "forward_reverse_partial", "reverse_only")


class Optimizer:
    """Global-norm clipping (optional) then Adam, over `params`."""

    def __init__(self, params, learning_rate: float, clip_grad_norm: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.clip_grad_norm = clip_grad_norm
        self.adam = torch.optim.Adam(
            self.params, lr=_f32(learning_rate), betas=(0.9, 0.999), eps=1e-8
        )

    @torch.no_grad()
    def step(self, grad_norm: Optional[Callable] = None) -> Optional[torch.Tensor]:
        """Clip the parameters' .grad in place and take one Adam step.
        Returns the global gradient norm before clipping (None unclipped):
        `grad_norm(grads)` when given (the norm over a mesh's ranks,
        `parallel/fsdp.py`), else the local one."""
        norm = None
        if self.clip_grad_norm is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = (grad_norm or (lambda gs: torch.nn.utils.get_total_norm(gs, 2.0)))(grads)
            c = self.clip_grad_norm
            factor = c / torch.clamp(norm, min=c)
            for g in grads:
                g.mul_(factor.to(g.dtype))
        self.adam.step()
        return norm


def _f32(lr: float) -> float:
    return float(np.float32(lr))


def make_optimizer(params, learning_rate: float, clip_grad_norm: Optional[float] = None) -> Optimizer:
    """Adam with optional global-norm clipping; the learning rate is
    mutable (`set_learning_rate`)."""
    return Optimizer(params, learning_rate, clip_grad_norm)


def get_learning_rate(opt: Optimizer) -> float:
    return float(opt.adam.param_groups[0]["lr"])


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    for group in opt.adam.param_groups:
        group["lr"] = _f32(lr)
    return opt


def _microbatches(batch: Dict[str, torch.Tensor], accum: int):
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not divisible by grad_accum {accum}")
    size = b // accum
    return [{k: v[i * size : (i + 1) * size] for k, v in batch.items()} for i in range(accum)]


def make_dalle_loss(model, mode: str = "forward_only", null_cond_prob: float = 0.0) -> Callable:
    """loss_fn(batch, generator) -> (loss, metrics), the reference step's
    loss composition for `mode`. `generator` (a CPU torch.Generator, the
    global one when None) seeds the step's null-conditioning draw."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

    def loss_fn(batch, generator: Optional[torch.Generator] = None, rows=None):
        """`rows` (offset, total): the batch is rows [offset, offset + B)
        of a global batch of `total` rows, whose null-conditioning draw is
        made whole and sliced (None: the batch is the whole of it)."""
        text, tokens = batch["text"], batch["image_tokens"]
        if null_cond_prob > 0:  # one draw shared by both objectives
            seed = int(torch.randint(0, 2**62, (1,), generator=generator))
            gen = torch.Generator(device=text.device).manual_seed(seed)
            offset, total = rows or (0, text.shape[0])
            draw = torch.rand((total, 1), generator=gen, device=text.device)
            # null conditioning: these rows' text all pad
            text = torch.where(draw[offset : offset + text.shape[0]] < null_cond_prob,
                               torch.zeros_like(text), text)

        def apply(**kw):
            return model(text, tokens, return_loss=True, **kw)

        metrics = {}
        if mode == "reverse_only":
            loss, acc = apply(inverse_mapping=True)
            metrics.update(inverse_loss=loss, accuracy=acc)
        else:
            loss, _ = apply()
            metrics["forward_loss"] = loss
            if mode != "forward_only":
                inv_loss, acc = apply(
                    inverse_mapping=True, reverse_model=mode == "forward_reverse_partial"
                )
                loss = loss + inv_loss
                metrics.update(inverse_loss=inv_loss, accuracy=acc)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def accumulate_gradients(
    model,
    loss_fn: Callable,
    batch: Dict[str, torch.Tensor],
    grad_accum: int = 1,
    generator: Optional[torch.Generator] = None,
    autocast_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Set every parameter's .grad to the microbatch-averaged gradient of
    `loss_fn` and return the averaged metrics (detached tensors). Over a
    training `mesh` the batch is this data rank's rows: `loss_fn` gets
    their place in the global microbatch, and each forward runs under the
    model's `FSDP` saved-tensor hooks."""
    model.train()
    for p in model.parameters():
        p.grad = None
    device_type = next(model.parameters()).device.type
    fsdp = fsdp_of(model)
    totals: Dict[str, torch.Tensor] = {}
    for mb in _microbatches(batch, grad_accum):
        extra = {}
        if mesh is not None:
            b = next(iter(mb.values())).shape[0]
            extra["rows"] = (mesh.data_rank * b, mesh.data_world * b)
        with torch.autocast(
            device_type, dtype=autocast_dtype or torch.bfloat16,
            enabled=autocast_dtype is not None,
        ), (fsdp.saving() if fsdp is not None else nullcontext()):
            loss, metrics = loss_fn(mb, generator, **extra)
        (loss / grad_accum).backward()
        for k, v in metrics.items():
            v = v.detach().float()
            totals[k] = totals[k] + v if k in totals else v
    return {k: v / grad_accum for k, v in totals.items()}


def encode_images(vae, images: torch.Tensor) -> torch.Tensor:
    """The frozen dVAE's codebook indices of `images` [B, H, W, C]: no
    gradient, in the VAE's float32 (without TF32: `encode_logits`),
    outside any autocast."""
    with torch.no_grad(), torch.autocast(images.device.type, enabled=False):
        return vae.get_codebook_indices(images.float())


def make_dalle_train_step(
    model,
    optimizer: Optimizer,
    mode: str = "forward_only",
    grad_accum: int = 1,
    null_cond_prob: float = 0.0,
    autocast_dtype: Optional[torch.dtype] = torch.bfloat16,
    vae=None,
    mesh=None,
) -> Callable:
    """step(batch, generator=None) -> metrics: one optimizer step on a
    batch (same device as the model) of {"text", "image_tokens"}, or of
    {"text", "images"} when a frozen `vae` is given (the in-step encode).
    `autocast_dtype` None computes in the parameters' dtype. With a
    training `mesh` of more than one rank the batch is this data rank's
    rows, the model is split by `FSDP` (its parameters and `optimizer`'s
    Adam state, in place; `parallel/fsdp.py:fsdp_of(model)`), and the
    metrics are the global batch's."""
    loss_fn = make_dalle_loss(model, mode, null_cond_prob)
    if vae is not None:
        vae.eval().requires_grad_(False)
    if mesh is not None and mesh.world == 1:
        mesh = None
    fsdp = FSDP(model, mesh, optimizer) if mesh is not None else None

    def step(batch, generator: Optional[torch.Generator] = None):
        if vae is not None and "image_tokens" not in batch:
            batch = {"text": batch["text"], "image_tokens": encode_images(vae, batch["images"])}
        metrics = accumulate_gradients(
            model, loss_fn, batch, grad_accum, generator, autocast_dtype, mesh
        )
        if fsdp is not None:
            fsdp.reduce_gradients()
            metrics = fsdp.mean_metrics(metrics)
        norm = optimizer.step() if fsdp is None else optimizer.step(fsdp.grad_norm)
        if norm is not None:
            metrics["grad_norm"] = norm
        return metrics

    return step


def make_vae_train_step(vae, optimizer: Optimizer, grad_accum: int = 1) -> Callable:
    """step(batch, temp, generator=None) -> metrics: one optimizer step of
    the dVAE on {"images": [B, H, W, C] in [0, 1]} at Gumbel temperature
    `temp` (the trainer anneals it), in float32. The batch may carry its
    Gumbel "noise" [B, h, w, num_tokens]; else each microbatch draws its
    own from `generator`."""

    def step(batch, temp: float, generator: Optional[torch.Generator] = None):
        def loss_fn(mb, gen):
            loss = vae(mb["images"], return_loss=True, temp=temp, noise=mb.get("noise"),
                       generator=gen)
            return loss, {"loss": loss}

        metrics = accumulate_gradients(vae, loss_fn, batch, grad_accum, generator)
        optimizer.step()
        return metrics

    return step


def make_clip_train_step(clip, optimizer: Optimizer, grad_accum: int = 1) -> Callable:
    """step(batch, generator=None) -> metrics: one optimizer step of CLIP's
    contrastive loss on {"text", "images"[, "text_mask"]}, in float32."""

    def loss_fn(batch, generator=None):
        loss = clip(batch["text"], batch["images"], text_mask=batch.get("text_mask"),
                    return_loss=True)
        return loss, {"loss": loss}

    def step(batch, generator: Optional[torch.Generator] = None):
        metrics = accumulate_gradients(clip, loss_fn, batch, grad_accum, generator)
        optimizer.step()
        return metrics

    return step


def make_multi_step(step_fn: Callable, n_steps: int) -> Callable:
    """multi(batches, keys) -> mean metrics: `step_fn(batch, key)` for
    each of the window's `n_steps` batches in turn (a list of per-step
    batches), batch i with key `keys[i]` (from `window_keys`)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")

    def multi(batches: Sequence[Dict[str, torch.Tensor]], keys: Sequence[int]):
        if len(batches) != n_steps or len(keys) != n_steps:
            raise ValueError(f"a window of {n_steps} steps got {len(batches)} batches, {len(keys)} keys")
        totals: Dict[str, torch.Tensor] = {}
        for batch, key in zip(batches, keys):
            metrics = step_fn(batch, key)
            for k, v in metrics.items():
                totals[k] = totals[k] + v if k in totals else v
        return {k: v / n_steps for k, v in totals.items()}

    return multi


def step_key(seed: int, global_step: int) -> int:
    """The key of optimizer step `global_step` of a run seeded `seed`."""
    return row_seed(seed, global_step)


def window_keys(seed: int, start_step: int, n: int) -> List[int]:
    """The keys of steps start_step .. start_step + n - 1 (`step_key`)."""
    return [step_key(seed, start_step + i) for i in range(n)]


def stack_batches(batches: list) -> Dict[str, np.ndarray]:
    """Per-step host batches -> one window with a leading [n_steps] axis
    on every leaf: the reference's window layout (one host-to-device copy
    a window), for a captured window; the trainer's loop keeps them
    apart."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def window_iter(it, n: int):
    """Group an iterator into lists of `n` (the last may be shorter: an
    epoch tail, which the trainer runs one step at a time)."""
    buf = []
    for b in it:
        buf.append(b)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf
