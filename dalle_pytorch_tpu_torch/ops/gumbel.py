"""Gumbel-softmax relaxation with the straight-through and ReinMax
estimators: the dVAE's codebook sampling.

Counterpart of the JAX package's `ops/gumbel.py:gumbel_softmax`: soft
(the relaxed one-hot), hard (the exact one-hot forward with the
straight-through gradient of the soft sample) and ReinMax (hard, with the
second-order correction of https://arxiv.org/abs/2304.08612, algorithm 2).

The noise is the caller's: a [..] tensor of standard Gumbel samples of the
logits' shape (`gumbel_noise`, drawn from an explicit `torch.Generator`),
so a test can inject the JAX side's. The port's draws are torch's, not
jax.random's bits: the same seed gives other samples than the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(torch.clamp(t, min=eps))


def gumbel_noise(
    shape, generator: Optional[torch.Generator] = None, device=None, dtype=torch.float32
) -> torch.Tensor:
    """Standard Gumbel samples -log(-log(u)), u uniform in (0, 1), drawn
    from `generator` (torch's global one when None)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - torch.finfo(dtype).eps)))


def gumbel_softmax(
    logits: torch.Tensor,
    noise: torch.Tensor,
    tau: float = 1.0,
    hard: bool = False,
    reinmax: bool = False,
    dim: int = -1,
) -> torch.Tensor:
    """A Gumbel-softmax sample over `dim` with the Gumbel `noise` given.

    hard=False: the soft relaxed one-hot; hard=True: the exact one-hot
    forward with the straight-through gradient; reinmax=True (with hard):
    the ReinMax gradient correction."""
    y_soft = F.softmax((logits + noise.to(logits.dtype)) / tau, dim=dim)
    if not hard:
        return y_soft
    index = y_soft.argmax(dim=dim, keepdim=True)
    one_hot = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    if not reinmax:
        return one_hot + y_soft - y_soft.detach()
    pi0 = F.softmax(logits, dim=dim)
    pi1 = (one_hot + F.softmax(logits / tau, dim=dim)) / 2.0
    pi1 = F.softmax((_log(pi1) - logits).detach() + logits, dim=dim)
    pi2 = 2.0 * pi1 - 0.5 * pi0
    return pi2 - pi2.detach() + one_hot
