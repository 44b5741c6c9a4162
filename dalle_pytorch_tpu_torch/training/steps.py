"""The DALLE training step: loss, gradients and the Adam update.

Counterpart of the JAX package's `training/steps.py` (`make_optimizer`,
`get_learning_rate` / `set_learning_rate`, `make_dalle_train_step` with
its `_accumulate` / `_microbatch`), for a batch of precomputed image
tokens: {"text": [B, T] ids, "image_tokens": [B, N] ids}, the route
`train_dalle.py --tokens_path` takes. The in-step dVAE encode and the
pipeline-parallel trunk are not ported.

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
torch's, the same formula. The learning rate is mutable.

Mixed precision: the reference keeps float32 parameters and computes in
bfloat16 through flax's `dtype`, which also makes its residual stream
bfloat16. Here `autocast_dtype=torch.bfloat16` runs the step under
`torch.autocast` over float32 parameters: matrix products and the
attention kernels take bfloat16 inputs, but the residual stream,
LayerNorm statistics and the loss stay float32. So the two round at
different places; losses agree closely, not bitwise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

MODES = ("forward_only", "forward_forward", "forward_reverse_partial", "reverse_only")


class Optimizer:
    """Global-norm clipping (optional) then Adam, over `params`."""

    def __init__(self, params, learning_rate: float, clip_grad_norm: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.clip_grad_norm = clip_grad_norm
        self.adam = torch.optim.Adam(
            self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """Clip the parameters' .grad in place and take one Adam step.
        Returns the global gradient norm before clipping (None unclipped)."""
        norm = None
        if self.clip_grad_norm is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.nn.utils.get_total_norm(grads, 2.0)
            c = self.clip_grad_norm
            factor = c / torch.clamp(norm, min=c)
            for g in grads:
                g.mul_(factor.to(g.dtype))
        self.adam.step()
        return norm


def make_optimizer(params, learning_rate: float, clip_grad_norm: Optional[float] = None) -> Optimizer:
    """Adam with optional global-norm clipping; the learning rate is
    mutable (`set_learning_rate`)."""
    return Optimizer(params, learning_rate, clip_grad_norm)


def get_learning_rate(opt: Optimizer) -> float:
    return float(opt.adam.param_groups[0]["lr"])


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    for group in opt.adam.param_groups:
        group["lr"] = float(lr)
    return opt


def _microbatches(batch: Dict[str, torch.Tensor], accum: int):
    b = batch["text"].shape[0]
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

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        text, tokens = batch["text"], batch["image_tokens"]
        seed = None
        if null_cond_prob > 0:  # one draw shared by both objectives
            seed = int(torch.randint(0, 2**62, (1,), generator=generator))

        def apply(**kw):
            gen = None
            if seed is not None:
                gen = torch.Generator(device=text.device).manual_seed(seed)
            return model(
                text, tokens, return_loss=True, null_cond_prob=null_cond_prob,
                generator=gen, **kw,
            )

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
) -> Dict[str, torch.Tensor]:
    """Set every parameter's .grad to the microbatch-averaged gradient of
    `loss_fn` and return the averaged metrics (detached tensors)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    device_type = next(model.parameters()).device.type
    totals: Dict[str, torch.Tensor] = {}
    for mb in _microbatches(batch, grad_accum):
        with torch.autocast(
            device_type, dtype=autocast_dtype or torch.bfloat16,
            enabled=autocast_dtype is not None,
        ):
            loss, metrics = loss_fn(mb, generator)
        (loss / grad_accum).backward()
        for k, v in metrics.items():
            v = v.detach().float()
            totals[k] = totals[k] + v if k in totals else v
    return {k: v / grad_accum for k, v in totals.items()}


def make_dalle_train_step(
    model,
    optimizer: Optimizer,
    mode: str = "forward_only",
    grad_accum: int = 1,
    null_cond_prob: float = 0.0,
    autocast_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> Callable:
    """step(batch, generator=None) -> metrics: one optimizer step on a
    batch of {"text", "image_tokens"} (same device as the model).
    `autocast_dtype` None computes in the parameters' dtype."""
    loss_fn = make_dalle_loss(model, mode, null_cond_prob)

    def step(batch, generator: Optional[torch.Generator] = None):
        metrics = accumulate_gradients(
            model, loss_fn, batch, grad_accum, generator, autocast_dtype
        )
        norm = optimizer.step()
        if norm is not None:
            metrics["grad_norm"] = norm
        return metrics

    return step
